"""Where the frame renderer and the chunked eval differ on the card, and why.

    python3 tngp_torch/diagnostics/frame_parity.py [--seed 0] [--res 800]

`chip_smoke.py` phase 3's frame (the flagship network with random weights
from --seed on bench.py's blob occupancy grid, pose 1 of
`orbit_poses(4, radius=2.35, elevation=0.3)`) rendered four ways:
`Trainer.render_image` (the frame renderer) and `render_image_chunked` (the
per-chunk `render_rays_eval` loop), each through the kernels and through
their plain versions, and the chunked loop at half the chunk; then a
reference without restarts: every ray's samples in one pass
(`render_rays_eval` with no per-ray chunk cap and a budget of every rung,
`eval_ray_chunk_cap=0`, `eval_budget = max_steps / K`).  A pass or round
that stops a ray resumes it at the t where it stopped and restarts the
rung ladder there; two paths that split a ray's samples at different points
place the later rungs an f32 rounding apart, and a rung that lands on the
other side of an occupancy-cell boundary joins or leaves the ray's samples.
Prints, for each pair, the pixels beyond image 1e-4 or depth 1e-3 and the
largest errors, and for each pixel where the frame renderer and the chunked
path differ, the three renders' values.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def main(seed: int = 0, res: int = 800) -> int:
    if not torch.cuda.is_available():
        print("frame_parity: no CUDA card visible; this run needs one", file=sys.stderr)
        return 2
    from tngp_torch import kernels
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
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True,
                       march_group=16)
    tr = Trainer(model, ds, cfg, TrainConfig(num_rays=4096, use_checkpoint="scratch"),
                 device=dev)
    density = make_blob_field(0, device=dev).density(
        None, cell_centers_cf(0, cfg.bound, cfg.grid_size, device=dev))[None]
    tr.set_grid(OccupancyGrid(
        density_grid=density, bitfield=packbits(density, cfg.density_thresh).reshape(-1),
        mean_density=density.mean(), iter_density=torch.zeros((), dtype=torch.int64, device=dev)))
    pose = orbit_poses(4, radius=2.35, elevation=0.3)[1]
    kw = dict(use_ema=False, W=res, H=res)

    out = {}
    out["frame"] = tr.render_image(pose, **kw)
    out["chunked"] = tr.render_image_chunked(pose, **kw)
    out["chunked, 2048-ray chunks"] = tr.render_image_chunked(pose, chunk=2048, **kw)
    with kernels.plain_versions():
        out["frame, plain versions"] = tr.render_image(pose, **kw)
        out["chunked, plain versions"] = tr.render_image_chunked(pose, **kw)
    tr.cfg = dataclasses.replace(cfg, eval_ray_chunk_cap=0,
                                 eval_budget=cfg.max_steps / cfg.K)
    out["one pass, no restarts"] = tr.render_image_chunked(pose, chunk=1024, **kw)
    rounds = tr.last_render_stats["rounds"]
    tr.cfg = cfg

    def compare(a, b):
        d_i = np.abs(out[a][0] - out[b][0]).max(axis=-1)
        d_d = np.abs(out[a][1] - out[b][1])
        bad = (d_i > 1e-4) | (d_d > 1e-3)
        print(f"{a} vs {b}: {int(bad.sum())} pixels beyond image 1e-4 or depth 1e-3, "
              f"max|err| image {float(d_i.max()):.3g}, depth {float(d_d.max()):.3g}")
        return bad

    ref = "one pass, no restarts"
    print(f"the reference without restarts ran {rounds} residual rounds (0: one pass)")
    bad = compare("frame", "chunked")
    for a, b in (("frame", "frame, plain versions"), ("chunked", "chunked, plain versions"),
                 ("chunked", "chunked, 2048-ray chunks"), ("frame", ref), ("chunked", ref)):
        compare(a, b)
    for y, x in np.argwhere(bad)[:10]:
        vals = "; ".join(f"{k} {np.array2string(out[k][0][y, x], precision=5)} "
                         f"depth {out[k][1][y, x]:.5f}" for k in ("frame", "chunked", ref))
        print(f"pixel ({y}, {x}): {vals}")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--res", type=int, default=800)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.exit(main(args.seed, args.res))
