"""Device time a step of the TensoRF and CCNeRF training steps on the card,
in a process of its own.

    python3 -m tngp_torch.diagnostics.tensor_steps [--seed 0] [--steps 16]

The trainers are those of `chip_smoke.py`'s phases 6g and 6h, built by the
same functions (`tensorf_trainer`, `ccnerf_trainer`) on the same scene and
render config (`scene`: 12 views of 128x128 of the blob scene, bench.py's
render config, 4096 rays a step): TensoRF VM after TF_WARM steps at its
first resolution (128), TensoRF VM after TF_STEPS steps, past the shrinks
and upsamples of TF_MILESTONES to its last resolution (~300^3), and
CCNeRF after 1 + CC_WARM steps.  Then `--steps` steps of each run under one
`torch.profiler` session, one `record_function` span a trainer (16 by
default: one grid-update interval, so that each window holds one grid
update, as the phases' timed windows hold one in 16 steps); a
trainer's device time is the sum of the device operations that start
inside its span.  This is the device side only: the phases time the same
steps by the host clock, and the idle share is 1 - device ms / their wall
(`chip_smoke.py` computes it).  A process gets one profiler session (after
a profile the profiler records nothing more), which is why `chip_smoke.py`
runs this as a subprocess.  Its progress goes to stderr as `# <seconds> s`
lines.  Prints one JSON line (name the card beside it:
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

TF_MILESTONES = (128, 176, 224, 272, 320)  # towards resolution1 300
TF_WARM, TF_STEPS = 32, 400  # steps before the first and the last window
CC_WARM = 32  # CCNeRF: steps after the first grid update, before its window
N_RAYS = 4096


def render_config():
    """bench.py's render config, as `chip_smoke.py` builds it."""
    from tngp_torch.render import RenderConfig

    return RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                        compact_fraction=0.25, density_thresh=1.0, march_dense=True,
                        march_group=16)


def scene(dev):
    """(the blob scene's 12 views of 128x128, `render_config()`)."""
    from tngp_torch.data import make_synthetic_dataset

    return make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev), render_config()


def tensorf_trainer(ds, cfg, seed: int, dev):
    """TensoRF VM at the CLI's defaults (resolution0 128, ranks 16 / 48,
    colour features 27, 3x128 bf16 MLP; density_thresh 10, lr 1e-2), the
    upsamples at TF_MILESTONES towards resolution1 300.  The bench config's
    density_thresh 1.0 is exp(0), the density of an empty TensoRF field, so
    no shrink would crop."""
    import dataclasses

    from tngp_torch.models import TensoRFNetwork
    from tngp_torch.train import TensoRFTrainer
    from tngp_torch.utils import TrainConfig

    cfg = dataclasses.replace(cfg, density_thresh=10.0)
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=seed, use_checkpoint="scratch")
    model = TensoRFNetwork(bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed)
    return TensoRFTrainer(model, ds, cfg, tc, upsample_model_steps=TF_MILESTONES,
                          resolution1=300, device=dev)


def ccnerf_trainer(ds, cfg, seed: int, dev):
    """CCNeRF at `CCConfig`'s defaults (resolution 128, SH degree 4, five
    groups), lr1 2e-2, lr2 1e-3, `cfg.K` slab slots a ray."""
    from tngp_torch.models import CCConfig
    from tngp_torch.train import CCTrainer
    from tngp_torch.utils import TrainConfig

    tc = TrainConfig(num_rays=N_RAYS, seed=seed, iters=30000, use_checkpoint="scratch")
    return CCTrainer(CCConfig(bound=1.0), ds, cfg, tc, lr1=2e-2, lr2=1e-3, device=dev)


# ranges the profiler also lays on the device's timeline (the optimizer's own,
# the spans here and the program's): annotations, not device work
_ANNOTATIONS = ("Optimizer.", "steps.", "tngp.")


def raw_events(prof) -> list:
    """(name, is a device event, start ns, duration ns) of each event the
    profiler recorded, read from its kineto results.  Building its
    `FunctionEvent` tree instead (`prof.events()`) took 63.7 s for the
    793,771 events of three trainers' 16 steps on an NVIDIA H100 80GB HBM3
    host, and gave the same spans to 1e-11 ms."""
    cuda_t = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda_t, e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _device_work(events):
    """The device operations of `raw_events` that took time."""
    return [(n, a, d) for n, dev, a, d in events
            if dev and d > 0 and not n.startswith(_ANNOTATIONS)]


def device_ms_in_spans(events, names) -> dict:
    """Device ms of the operations that start inside each `record_function`
    span of `names` (`raw_events`), by the profiler's clock.  A span's own
    device time would miss the backward's kernels, which autograd launches
    from its device thread, outside the span's thread."""
    spans = {n: (a, a + d) for n, dev, a, d in events if n in names and not dev}
    out = {n: 0.0 for n in spans}
    for _, a, d in _device_work(events):
        for n, (lo, hi) in spans.items():
            if lo <= a < hi:
                out[n] += d / 1e6
    return out


def top_kernels(events, n: int = 8) -> list:
    """(name, device ms, count) of the device operations with the most time."""
    tot: dict = {}
    for name, _, d in _device_work(events):
        ms, c = tot.get(name, (0.0, 0))
        tot[name] = (ms + d / 1e6, c + 1)
    rows = [(k[:80], ms, c) for k, (ms, c) in tot.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def main(seed: int = 0, steps: int = 16) -> int:
    if not torch.cuda.is_available():
        print("tensor_steps: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()

    def note(msg):
        print(f"# {time.time() - t0:7.1f} s {msg}", file=sys.stderr, flush=True)

    dev = torch.device("cuda")
    ds, cfg = scene(dev)
    trainers = {"tensorf_first": tensorf_trainer(ds, cfg, seed, dev),
                "tensorf_last": tensorf_trainer(ds, cfg, seed, dev),
                "ccnerf": ccnerf_trainer(ds, cfg, seed, dev)}
    note("trainers built")
    trainers["tensorf_first"].run_steps(TF_WARM)
    trainers["tensorf_last"].run_steps(TF_STEPS)
    trainers["ccnerf"].run_steps(1 + CC_WARM)
    torch.cuda.synchronize()
    note("warm steps done")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, tr in trainers.items():
            with record_function(f"steps.{name}"):
                tr.run_steps(steps)
                torch.cuda.synchronize()  # the span ends after its device work
    note("profiled steps done")
    events = raw_events(prof)
    spans = device_ms_in_spans(events, [f"steps.{n}" for n in trainers])
    note(f"{len(events)} profiler events read")
    out = {}
    for name, tr in trainers.items():
        res = tr.model.cfg.resolution if name == "ccnerf" else tr.model.resolution
        out[name] = {"device_ms_per_step": spans.get(f"steps.{name}", 0.0) / steps,
                     "resolution": list(res), "step": tr.global_step}
    out["top_kernels_all_three"] = top_kernels(events)
    out["steps"] = steps
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, here)
    sys.exit(main(args.seed, args.steps))
