"""D-NeRF training repeated in one process, as `chip_smoke.py`'s D-NeRF
phase trains it, with what each run did.

    python3 -m tngp_torch.diagnostics.dnerf_repeat [--runs 20] [--seed 0]
        [--vary-seed] [--out FILE]

Each run builds a fresh `DNeRFNetwork` (the flagship encoder with position
gradients, a 5x128 bf16 deform MLP) from the seed (--seed, or --seed + run
with --vary-seed) and a `DNeRFTrainer` under the phase's pinned config
(scripts/bench_dnerf_step.py's: bench.py's render config, a time grid of
16 x 128^3 updated every 16 steps, 4096 rays/step, no budget tiers) on the
same 12 views of 128x128 of the dynamic blob scene, trains it for 180 steps
(the phase's 64 + 100 + 16), then puts one more batch through the loss and
its backward (the phase's trained step).  With one seed the runs differ
only where the kernels add in an order that changes from run to run.

The bias-free 5x128 ReLU deform MLP dies in some of these trainings: its
largest |grad| is then 0 from some step on.  The phase holds the kernels on
a freshly built net, where the gradient must reach the deform net, and only
reports a dead net after training; so this counts dead nets as a finding of
its own, apart from the phase's failures (the loss not halving, a
non-finite gradient).

Per run it records the loss, the sample count and the deform net's largest
|grad| of every step (and the step from which that stays 0, if it does),
the mean loss of the first and last 16 steps and whether the last fell
below half the first (the phase's check), the time grid's occupied share,
the deform net's largest |dx| over 4096 fixed points at each frame's time,
and for the extra batch its time, sample count and loss, the deform net's
largest |grad| (0: a dead net) and the count of non-finite entries of each
gradient (the phase wants none).  It prints one JSON line per run, then a
summary line with the failure count, the dead-net count and the failing
and dead runs' values; --out writes every record to a file.  It needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

STEPS = 180  # chip_smoke.py's D-NeRF phase: 64 untimed + 100 timed + 16 sync-checked
FRAMES, RES, TIME_SIZE, GRID_SIZE, N_RAYS = 12, 128, 16, 128, 4096


def one_run(dds, seed: int) -> dict:
    from tngp_torch.models import DNeRFNetwork
    from tngp_torch.render import RenderConfig
    from tngp_torch.train import DNeRFTrainer
    from tngp_torch.utils import TrainConfig

    dev = torch.device("cuda")
    cfg = RenderConfig(bound=1.0, grid_size=GRID_SIZE, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True)
    model = DNeRFNetwork(bound=1.0, encoding="hashgrid_window", compute_dtype=torch.bfloat16,
                         device=dev, seed=seed)
    tr = DNeRFTrainer(model, dds, cfg, TrainConfig(num_rays=N_RAYS, iters=100_000,
                                                   adaptive_budget=False, seed=seed,
                                                   use_checkpoint="scratch"),
                      time_size=TIME_SIZE, update_interval=16, device=dev)
    deform = [p for n, p in model.named_parameters() if n.startswith("deform_net")]
    t0 = time.time()
    losses, pts, gmax = [], [], []
    for _ in range(STEPS):  # one at a time: the step leaves its gradients behind
        loss_s, pts_s, _ = tr.run_steps(1)
        losses.append(loss_s[0])
        pts.append(pts_s[0])
        gmax.append(torch.stack([p.grad.abs().max() for p in deform]).max())
    losses, pts, gmax = (torch.stack(v).tolist() for v in (losses, pts, gmax))
    wall = time.time() - t0
    dead_from = next((s for s in range(STEPS) if not any(gmax[s:])), None)
    probe = torch.rand((3, 4096), generator=torch.Generator().manual_seed(1)).to(dev) * 2 - 1
    with torch.no_grad():
        dx_max = [float(model._deform_cf(probe, t)[2].abs().max()) for t in tr.times]
    first16, last16 = sum(losses[:16]) / 16, sum(losses[-16:]) / 16
    grid = tr.grid
    occupied = float((grid.density_grid > torch.clamp(grid.mean_density, max=cfg.density_thresh))
                     .float().mean())

    batch = tr.sample_batch()
    tr.optimizer.zero_grad(set_to_none=True)
    loss, npts, _ = tr.loss_on_batch(batch)
    loss.backward()
    named = [(n, p.grad) for n, p in model.named_parameters() if p.requires_grad]
    deform_max = max(float(g.abs().max()) if g is not None else 0.0
                     for n, g in named if n.startswith("deform_net"))
    nonfinite = {n: int((~torch.isfinite(g)).sum()) for n, g in named
                 if g is not None and not bool(torch.isfinite(g).all())}
    tr.optimizer.zero_grad(set_to_none=True)
    halved = bool(last16 < 0.5 * first16)
    return dict(seed=seed, wall_s=wall, first16=first16, last16=last16, halved=halved,
                occupied=occupied, deform_dead_from=dead_from, probe_dx_max=dx_max,
                batch_time=float(batch["time"]), batch_samples=int(npts),
                batch_loss=float(loss.detach()), deform_max_grad=deform_max,
                dead=deform_max == 0, nonfinite=nonfinite,
                failed=not halved or bool(nonfinite), losses=losses, samples=pts,
                deform_grad_max=gmax)


def main(runs: int = 20, seed: int = 0, vary_seed: bool = False, out: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("dnerf_repeat: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    from tngp_torch.data import make_synthetic_dynamic_dataset

    dds = make_synthetic_dynamic_dataset(n_frames=FRAMES, H=RES, W=RES, seed=0,
                                         device=torch.device("cuda"))
    records = []
    for r in range(runs):
        rec = one_run(dds, seed + r if vary_seed else seed)
        rec["run"] = r
        records.append(rec)
        brief = {k: v for k, v in rec.items()
                 if k not in ("losses", "samples", "deform_grad_max")}
        print(json.dumps(brief), flush=True)
    last16 = [r["last16"] for r in records]
    keys = ("run", "seed", "first16", "last16", "occupied", "deform_dead_from", "probe_dx_max",
            "batch_time", "batch_samples", "batch_loss", "deform_max_grad", "nonfinite")
    summary = dict(runs=runs, failed=sum(r["failed"] for r in records),
                   halving_failed=sum(not r["halved"] for r in records),
                   nonfinite=sum(bool(r["nonfinite"]) for r in records),
                   last16_range=[min(last16), max(last16)],
                   dead_at_batch=sum(r["dead"] for r in records),
                   deform_dead=sum(r["deform_dead_from"] is not None for r in records),
                   failing_runs=[{k: r[k] for k in keys} for r in records if r["failed"]],
                   dead_runs=[{k: r[k] for k in keys} for r in records if r["dead"]])
    print(json.dumps(summary), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({"summary": summary, "records": records}, f)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vary-seed", action="store_true",
                    help="seed run r with --seed + r (default: every run with --seed)")
    ap.add_argument("--out", default=None, help="write every run's record to this JSON file")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, here)
    sys.exit(main(args.runs, args.seed, args.vary_seed, args.out))
