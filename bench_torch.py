"""Benchmark of the PyTorch/H100 port, the counterpart of `bench.py`.

    python3 bench_torch.py            # on the CUDA card
    TNGP_PLATFORM=cpu python3 bench_torch.py

Prints bench.py's one JSON line, {"metric": "train_rays_per_s", "value",
"unit", "vs_baseline", "tier_M", "eval_rays_per_s", "eval_vs_baseline",
"eval_psnr_db", "eval800_rays_per_s", "eval800_vs_baseline"}, with two
keys of its own, "eval800_rounds" and "eval800_rays_cut": each timed
frame's residual rounds and the rays that `max_rounds` left alive in it
(eval800 is the rate of complete frames only where those are 0).  Its
progress and each eval800 frame's rounds, tiers and host reads go to stderr.

bench.py's workload: the tracked blob scene `.cache/synth_bench.npz` (12
views of 128x128), the flagship network (window encoder, bf16 MLPs) with
random weights from seed 0, bench.py's `RenderConfig`, 4096 rays/step, Adam
at a constant lr 1e-2, budget tiers f/4, f/2, f read every 16 steps, a grid
update every 16 steps (full for the first 32), `TNGP_BENCH_WARMUP` (1024)
untimed steps and 100 timed ones (grid updates and tier reads included).
The step is `tngp_torch.train.Trainer`'s, which keeps a per-step EMA that
bench.py's loop does not.  Then the PSNR of view 0 and the rays/s of view 1
through the chunked `render_rays_eval` (4096-ray chunks), and eval800:
800x800 frames through the frame renderer with bench.py's eval config
(eval_budget 0.125, eval_march_chunk 32, eval_round_ladder 256,
eval_cb_mult 6.0, chunk `TNGP_BENCH_EVAL_CHUNK` = 16384), `warmup`, one warm
frame and three timed ones of `orbit_poses(4, radius=2.35, elevation=0.3)`.
All evals use the live weights, as bench.py's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_RAYS_PER_S = 97 * 4096  # the reference's V100 (BASELINE.md)
EVAL_BASELINE_RAYS_PER_S = 7.8 * 800 * 800  # 7.8 test frames/s at 800x800 on the V100
N_RAYS = 4096
N_TIMED = 100
CACHE = os.path.join(ROOT, ".cache", "synth_bench.npz")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> dict:
    sys.path.insert(0, ROOT)
    from tngp_torch.cli.common import select_device
    from tngp_torch.data import NeRFDataset, full_image_rays, orbit_poses
    from tngp_torch.models import NGPNetwork
    from tngp_torch.render import FrameRenderer, RenderConfig
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    t_start = time.time()
    dev = select_device()
    z = np.load(CACHE)
    ds = NeRFDataset(poses=z["poses"], intrinsics=z["intrinsics"], H=int(z["H"]),
                     W=int(z["W"]), images=z["images"])
    model = NGPNetwork(encoding="hashgrid_window",
                       bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=0)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True,
                       march_group=16)
    tc = TrainConfig(num_rays=N_RAYS, lr=1e-2, seed=0, adaptive_overdrive=False,
                     use_checkpoint="scratch")
    tr = Trainer(model, ds, cfg, tc, device=dev, constant_lr=True, full_grid_updates=2)
    log(f"dataset and trainer ready {time.time() - t_start:.1f}s on {dev}")

    warm_steps = int(os.environ.get("TNGP_BENCH_WARMUP", "1024"))
    tr.run_steps(warm_steps)
    sync(dev)
    log(f"warmup done {time.time() - t_start:.1f}s (tier M={tr.tier_M})")
    t0 = time.time()
    tr.run_steps(N_TIMED)
    sync(dev)
    dt = time.time() - t0
    log(f"timed done: tier M={tr.tier_M}")

    # the chunked eval: PSNR of view 0, then the rays/s of view 1
    img, _ = tr.render_image_chunked(ds.poses[0], use_ema=False, chunk=N_RAYS)
    mse = float(np.mean((img - ds.images[0]) ** 2))
    log(f"eval view PSNR after warmup+{N_TIMED} steps: {-10 * np.log10(max(mse, 1e-12)):.2f} dB")
    sync(dev)
    te0 = time.time()
    tr.render_image_chunked(ds.poses[1], use_ema=False, chunk=N_RAYS)  # returns host arrays
    eval_rays_s = ds.H * ds.W / (time.time() - te0)
    log(f"eval throughput: {eval_rays_s:,.0f} rays/s ({eval_rays_s / (ds.H * ds.W):.2f} "
        f"frames/s at {ds.H}x{ds.W})")

    # eval800 through the frame renderer
    R = 800
    intr800 = torch.as_tensor(ds.intrinsics, device=dev) * (R / float(ds.H))
    eval_cfg = dataclasses.replace(cfg, eval_budget=0.125, eval_march_chunk=32,
                                   eval_round_ladder=256, eval_cb_mult=6.0)
    fr = FrameRenderer(tr.field, eval_cfg,
                       chunk=int(os.environ.get("TNGP_BENCH_EVAL_CHUNK", "16384")))
    bitfield = tr.grid.bitfield
    fr.warmup(None, bitfield, R * R)
    test_poses = orbit_poses(4, radius=2.35, elevation=0.3)
    frames, rounds, cut = [], [], []
    for i, pose in enumerate(test_poses):
        sync(dev)
        te0 = time.time()
        o8, d8 = full_image_rays(pose, intr800, R, R, device=dev)
        img8, _ = fr.render(None, o8, d8, bitfield)
        img8.cpu()
        frames.append(time.time() - te0)
        st = fr.last_stats
        rounds.append(st["rounds"])
        cut.append(int(fr.last_cut.sum()))
        log(f"eval800 frame {i}{' (warm)' if i == 0 else ''}: {frames[-1]:.3f} s, "
            f"{st['rounds']} rounds at tiers {st['tiers']}, {st['host_reads']} host reads, "
            f"{st['chunks_marched']}/{st['chunks']} chunks marched, "
            f"{st['valid_samples']:,} samples, {cut[-1]} rays still alive at "
            f"max_rounds")
    eval800_rays_s = (len(test_poses) - 1) * R * R / sum(frames[1:])
    log(f"eval800 throughput: {eval800_rays_s:,.0f} rays/s ({eval800_rays_s / (R * R):.2f} "
        f"frames/s at {R}x{R})")

    rays_s = N_TIMED * N_RAYS / dt
    out = {
        "metric": "train_rays_per_s",
        "value": round(rays_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_s / BASELINE_RAYS_PER_S, 3),
        "tier_M": tr.tier_M,
        "eval_rays_per_s": round(eval_rays_s, 1),
        "eval_vs_baseline": round(eval_rays_s / EVAL_BASELINE_RAYS_PER_S, 4),
        "eval_psnr_db": round(-10 * np.log10(max(mse, 1e-12)), 2),
        "eval800_rays_per_s": round(eval800_rays_s, 1),
        "eval800_vs_baseline": round(eval800_rays_s / EVAL_BASELINE_RAYS_PER_S, 4),
        # the timed frames' residual rounds and the rays their round cap
        # (`max_rounds`) left alive: a frame with cut rays is not complete
        "eval800_rounds": rounds[1:],
        "eval800_rays_cut": cut[1:],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
