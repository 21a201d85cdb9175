"""Wall time of the instant-NGP eval frame and training step on the card, as
`chip_smoke.py` phases 3 and 4 drive them, in a process of its own.

    python3 tngp_torch/diagnostics/step_times.py [--root DIR] [--seed 0] [--profile]

The flagship network (random weights from --seed): a warm-up and a timed
800x800 frame on bench.py's blob occupancy grid (4096-ray chunks), then on
12 views of 128x128 of the blob scene, 4096 rays/step, lr 1e-2, grid
update and budget-tier read every 16 steps: 200 untimed steps and three
windows of 100 steps, each timed by the host clock between two
synchronizes (grid updates and tier reads included).  Both are host-bound,
so these walls are mostly the host's enqueue cost.  `--root DIR` imports `tngp_torch` from another
checkout (say the parent commit's, in a git-ignored directory), so two
versions can alternate on one card in one call.  Prints one JSON line
(name the card beside it: `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`).  `--profile` also profiles, with input shapes
recorded, one more eval frame and one partial (resample) grid update of
`bench_grid_update` (H = 128) and adds, for each, the device time of all
its device operations and of its cumsums by input shape, so that one
scan's device time can be told from another's (the bin sort's [NBk, 64]
block-histogram scan from the march's and the compositor's).  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

WARM_STEPS, WINDOW, WINDOWS = 200, 100, 3


def ops_by_shape(prof, names=("aten::cumsum",)) -> list:
    """From a `torch.profiler` run with `record_shapes=True`: per op in
    `names` and distinct input shapes, (op, shapes, calls, device ms), the
    largest first: the device time of the kernels each call launched itself
    (`cummax`'s kernel is charged to an inner op of another name, so its
    time shows in the profile's kernel table instead)."""
    rows = [(e.key, str(e.input_shapes), e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in names and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[3])


def profiled(fn) -> dict:
    """Device ms of all device operations of one `fn()` and its cumsums by
    input shape (`ops_by_shape`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == cuda_t and e.device_time_total > 0
               and not e.key.startswith(("Optimizer.", "tngp."))) / 1e3
    return {"device_ms": busy, "scans": ops_by_shape(prof)}


def main(seed: int = 0, profile: bool = False) -> int:
    if not torch.cuda.is_available():
        print("step_times: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    import tngp_torch
    from tngp_torch.data import make_blob_field, make_synthetic_dataset, orbit_poses
    from tngp_torch.models import NGPNetwork
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.render import OccupancyGrid, RenderConfig, cell_centers_cf
    from tngp_torch.train import Trainer
    from tngp_torch.utils import TrainConfig

    dev = torch.device("cuda")
    ds = make_synthetic_dataset(n_frames=12, H=128, W=128, seed=0, device=dev)
    model = NGPNetwork(encoding="hashgrid_window",
                       bound=1.0, compute_dtype=torch.bfloat16, device=dev, seed=seed)
    cfg = RenderConfig(bound=1.0, grid_size=128, max_steps=512, K=128, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True)
    tc = TrainConfig(num_rays=4096, lr=1e-2, seed=seed, adaptive_overdrive=False,
                     use_checkpoint="scratch")
    tr = Trainer(model, ds, cfg, tc, device=dev, constant_lr=True, full_grid_updates=2)
    grid0 = tr.grid
    density = make_blob_field(0, device=dev).density(
        None, cell_centers_cf(0, cfg.bound, cfg.grid_size, device=dev))[None]
    tr.set_grid(OccupancyGrid(
        density_grid=density, bitfield=packbits(density, cfg.density_thresh).reshape(-1),
        mean_density=density.mean(), iter_density=torch.zeros((), dtype=torch.int64, device=dev)))
    poses = orbit_poses(4, radius=2.35, elevation=0.3)
    tr.render_image(poses[0], use_ema=False, chunk=4096, W=800, H=800)
    t0 = time.perf_counter()
    tr.render_image(poses[1], use_ema=False, chunk=4096, W=800, H=800)  # returns host arrays
    frame_s = time.perf_counter() - t0
    profiles = {}
    if profile:
        from tngp_torch.diagnostics import bench_grid_update as bg
        from tngp_torch.render import FieldFns

        profiles["eval_frame"] = profiled(
            lambda: tr.render_image(poses[1], use_ema=False, chunk=4096, W=800, H=800))
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        grid_g = bg.occupied_grid(bg.H, gen)
        dens = FieldFns.from_model(model).density
        bg.partial_update(grid_g, dens, bg.H, gen, "resample")  # warm-up
        profiles["grid_update"] = profiled(
            lambda: bg.partial_update(grid_g, dens, bg.H, gen, "resample"))
    tr.set_grid(grid0)
    tr.run_steps(WARM_STEPS)
    ms = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_steps(WINDOW)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / WINDOW * 1e3)
    print(json.dumps({"package": os.path.dirname(tngp_torch.__file__), "frame_s": frame_s,
                      "eval_rays_s": 800 * 800 / frame_s, "tier_M": tr.tier_M,
                      "ms_per_step": ms, **profiles}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="import tngp_torch from this checkout (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile an eval frame and a partial grid update, scans by shape")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root) if args.root else here)
    sys.exit(main(args.seed, args.profile))
