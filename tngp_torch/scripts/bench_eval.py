"""Eval throughput at the reference's conditions — the port of
`scripts/bench_eval.py`: full 800x800 frames of the TRAINED hard scene
(occupancy grid sparsified, early termination active) from the checkpoint
that `train_hard` wrote.  The reference's V100 renders 7.8 frames/s at
800x800 (readme.md:211) = 4.99M rays/s.

    python -m tngp_torch.scripts.bench_eval [--workspace <tmp>/hard_base]
        [--res 800] [--frames 8] [--chunk 8192] [--eval_budget 0.75]

On the card (the CPU with `TNGP_PLATFORM=cpu`).  A sanity PSNR on view 0 at
the dataset's resolution and one warm-up frame, then `--frames` timed
frames at fresh orbit poses (radius 2.35, elevation 0.3); each frame's
residual rounds and the rays a round cap left alive go to stderr on `#`
lines.  Prints one JSON line: metric, value (rays/s), unit, frames_per_s,
res, vs_baseline, and the frames' rounds and cut rays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_RAYS_PER_S = 7.8 * 800 * 800  # V100 test it/s (readme.md:211)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workspace", default=os.path.join(tempfile.gettempdir(), "hard_base"))
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--compact_fraction", type=float, default=0.25)
    ap.add_argument("--eval_budget", type=float, default=0.75,
                    help="first-pass sample budget as a fraction of N*K")
    return ap


def bench_eval(opt, data=None, device=None, model_kw=None, cfg_kw=None) -> dict:
    """The benchmark of `opt`; returns the JSON line's dict (None when the
    cache or the checkpoint is missing, after saying so on stderr).  `data`,
    `model_kw` and `cfg_kw` as `train_hard.train_hard`'s."""
    import torch

    from ..cli.common import select_device
    from ..data.provider import NeRFDataset
    from ..data.synthetic import orbit_poses
    from ..models import NGPNetwork
    from ..render import RenderConfig
    from ..train import Trainer
    from ..utils.config import TrainConfig
    from .train_hard import CACHE

    if data is None:
        if not CACHE.exists():
            print("no .cache/hard_256.npz: run tngp_torch.scripts.train_hard first",
                  file=sys.stderr)
            return None
        z = np.load(CACHE)
        data = z["poses"], z["intrinsics"], z["images"]
    poses, intr, images = data
    dev = device if device is not None else select_device()
    H, W = images.shape[1:3]
    ds = NeRFDataset(poses=poses, intrinsics=intr, H=H, W=W, images=images.astype(np.float32))
    model = NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, encoding="hashgrid_window",
                       device=dev, **(model_kw or {}))
    cfg = RenderConfig(**{**dict(bound=1.0, grid_size=128, max_steps=512, K=128,
                                 min_near=0.05, compact_fraction=opt.compact_fraction,
                                 density_thresh=10.0, march_dense=True,
                                 eval_budget=opt.eval_budget), **(cfg_kw or {})})
    tc = TrainConfig(name=os.path.basename(os.path.normpath(opt.workspace)),
                     workspace=opt.workspace, use_checkpoint="latest")
    trainer = Trainer(model, ds, cfg, tc, device=dev)
    if trainer.global_step == 0:
        print(f"no checkpoint found in {opt.workspace}: run train_hard", file=sys.stderr)
        return None

    R = opt.res
    t0 = time.time()
    img, _ = trainer.render_image(ds.poses[0], chunk=opt.chunk)
    mse = float(np.mean((img - np.asarray(ds.images[0])[..., :3]) ** 2))
    sanity = -10 * np.log10(max(mse, 1e-12))
    print(f"# sanity PSNR ({H}x{W} view 0): {sanity:.2f} dB", file=sys.stderr, flush=True)
    trainer.render_image(ds.poses[1], W=R, H=R, chunk=opt.chunk)
    print(f"# warmup {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    rounds, cut = [], []
    t0 = time.time()
    for p in orbit_poses(opt.frames, radius=2.35, elevation=0.3):
        trainer.render_image(p, W=R, H=R, chunk=opt.chunk)  # returns host arrays
        st = trainer.last_render_stats
        rounds.append(int(st.get("rounds", 0)))
        cut.append(int(trainer.last_render_cut.sum()))
        print(f"# frame: {time.time() - t0:.2f}s cum, {rounds[-1]} residual rounds, "
              f"{cut[-1]} rays left alive by the round cap", file=sys.stderr, flush=True)
    dt = time.time() - t0
    frames_s = opt.frames / dt
    rays_s = frames_s * R * R
    return {"metric": "eval_rays_per_s", "value": round(rays_s, 1), "unit": "rays/s",
            "frames_per_s": round(frames_s, 3), "res": R,
            "vs_baseline": round(rays_s / BASELINE_RAYS_PER_S, 4),
            "sanity_psnr_db": round(float(sanity), 2), "rounds": rounds, "rays_cut": cut}


def main(argv=None) -> int:
    result = bench_eval(build_parser().parse_args(argv))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
