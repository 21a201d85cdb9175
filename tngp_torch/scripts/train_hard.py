"""The hard-scene training run — the port of `scripts/train_hard.py`: the
100-view 256^2 hard scene (`.cache/hard_256.npz`, tracked in git; rendered
with `make_hard_field` only when the file is absent), 5 views held out for
validation, the flagship window-encoder NGP with bf16 MLPs, bench.py's
render config, 500 steps an epoch and a validation every 5 epochs.

    python -m tngp_torch.scripts.train_hard [--error_map] [--iters 30000]
        [--tag name] [--workspace DIR] [--mxu_f32] ...

On the card (the CPU with `TNGP_PLATFORM=cpu`).  Writes the time-to-PSNR
curve to <workspace>/curve.json, logs each epoch, saves a checkpoint at each
validation and after the last epoch (the JAX script saves only at the
validations; `bench_eval` reads the last), and prints one JSON line:
{"tag", "final_psnr", "wall_s", "curve"}, and the train loop's
"ms_per_step", the epochs' mean losses, whether the encoder ran its f32
form and the workspace.  The learning rate decays to 0.1x over `--iters`,
as in the JAX script, so a short `--iters` run ends at a tenth of it
(`train_hard(max_steps=)` cuts a run and keeps the schedule).
`--mxu_f32` sets `TNGP_MXU_F32=1` (the window encoder's true-f32 form), as
the JAX script does.  The workspace defaults to <tmp>/hard_<tag>.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

CACHE = Path(__file__).resolve().parents[2] / ".cache" / "hard_256.npz"
N_VAL = 5


def get_hard_dataset(n_frames=100, H=256, W=256, device="cuda"):
    """(poses, intrinsics, images) of the hard scene: the cache, else a
    render of `make_hard_field` written to it."""
    if CACHE.exists():
        z = np.load(CACHE)
        return z["poses"], z["intrinsics"], z["images"]
    from ..data.synthetic import make_hard_dataset

    t0 = time.time()
    ds = make_hard_dataset(n_frames, H, W, device=device)
    print(f"# GT rendered in {time.time() - t0:.0f}s", file=sys.stderr)
    CACHE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(CACHE, poses=ds.poses, intrinsics=ds.intrinsics, images=ds.images)
    return ds.poses, ds.intrinsics, ds.images


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--error_map", action="store_true")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--compact_fraction", type=float, default=0.25)
    ap.add_argument("--tag", type=str, default=None)
    ap.add_argument("--workspace", type=str, default=None,
                    help="default <tmp>/hard_<tag>")
    ap.add_argument("--encoding", type=str, default="hashgrid_window",
                    help="hashgrid_window (the kernels) | hashgrid (golden grid)")
    ap.add_argument("--no_overdrive", action="store_true",
                    help="disable the above-configured-budget tier (A/B)")
    ap.add_argument("--no_adaptive", action="store_true",
                    help="disable the budget-tier ladder entirely (A/B)")
    ap.add_argument("--march_chunk", type=int, default=8,
                    help="0 = the stream march")
    ap.add_argument("--mxu_f32", action="store_true",
                    help="the window encoder's true-f32 form (TNGP_MXU_F32=1)")
    return ap


def train_hard(opt, data=None, device=None, model_kw=None, cfg_kw=None, tc_kw=None,
               steps_per_epoch: int = 500, max_steps: Optional[int] = None) -> dict:
    """The run of `opt` (the parser's namespace); returns the JSON line's
    dict.  `data` (poses, intrinsics, images) replaces the cache, and
    `model_kw` / `cfg_kw` / `tc_kw` / `steps_per_epoch` narrow the model,
    the render config, the train config and the epochs for a small run;
    `max_steps` stops the run after the epoch that reaches it, while the
    learning rate still decays over `opt.iters` (the first steps of the
    full run).  The script passes none of them."""
    import torch

    from ..cli.common import select_device
    from ..data.provider import NeRFDataset
    from ..models import NGPNetwork
    from ..render import RenderConfig
    from ..train import Trainer
    from ..utils.config import TrainConfig

    if opt.mxu_f32:
        os.environ["TNGP_MXU_F32"] = "1"
    tag = opt.tag or ("em" if opt.error_map else "base")
    dev = device if device is not None else select_device()
    poses, intr, images = data if data is not None else get_hard_dataset(device=dev)
    H, W = images.shape[1:3]
    train_ds = NeRFDataset(poses=poses[N_VAL:], intrinsics=intr, H=H, W=W,
                           images=images[N_VAL:].astype(np.float32))
    val_ds = NeRFDataset(poses=poses[:N_VAL], intrinsics=intr, H=H, W=W,
                         images=images[:N_VAL].astype(np.float32))

    model = NGPNetwork(bound=1.0, compute_dtype=torch.bfloat16, encoding=opt.encoding,
                       device=dev, **(model_kw or {}))
    cfg = RenderConfig(**{**dict(bound=1.0, grid_size=128, max_steps=512, K=128,
                                 min_near=0.05, compact_fraction=opt.compact_fraction,
                                 density_thresh=10.0, march_dense=True,
                                 march_chunk=opt.march_chunk), **(cfg_kw or {})})
    tc = TrainConfig(
        name=f"hard_{tag}",
        workspace=opt.workspace or os.path.join(tempfile.gettempdir(), f"hard_{tag}"),
        iters=opt.iters, num_rays=4096, steps_per_epoch=steps_per_epoch, eval_interval=5,
        error_map=opt.error_map, use_checkpoint="scratch",
        adaptive_budget=not opt.no_adaptive, adaptive_overdrive=not opt.no_overdrive,
        **(tc_kw or {}),
    )
    os.makedirs(tc.workspace, exist_ok=True)
    trainer = Trainer(model, train_ds, cfg, tc, valid_dataset=val_ds, device=dev)

    def write_curve():
        with open(os.path.join(tc.workspace, "curve.json"), "w") as f:
            json.dump(curve, f)

    curve = []
    t0 = time.time()
    train_s = 0.0
    n_epochs = -(-min(opt.iters, max_steps or opt.iters) // steps_per_epoch)
    for _ in range(n_epochs):
        trainer.epoch += 1
        t1 = time.time()
        trainer.train_one_epoch(steps_per_epoch)  # ends in a host read: the steps are done
        train_s += time.time() - t1
        if trainer.epoch % tc.eval_interval == 0:
            psnr = float(trainer.evaluate(val_ds))
            curve.append({"step": trainer.global_step, "wall_s": time.time() - t0,
                          "psnr": psnr})
            print(f"# step {trainer.global_step} wall {time.time() - t0:.0f}s "
                  f"PSNR {psnr:.2f}", file=sys.stderr, flush=True)
            write_curve()
            trainer.save_checkpoint(best=False)
    psnr = float(trainer.evaluate(val_ds, write_images=True))
    curve.append({"step": trainer.global_step, "wall_s": time.time() - t0, "psnr": psnr,
                  "final": True})
    write_curve()
    trainer.save_checkpoint(best=False)
    return {"tag": tag, "final_psnr": psnr, "wall_s": time.time() - t0, "curve": curve,
            "ms_per_step": 1e3 * train_s / max(trainer.global_step, 1),
            "epoch_losses": trainer.stats["loss"],
            "mxu_f32": bool(getattr(model.encoder, "mxu_f32", False)),
            "workspace": tc.workspace}


def main(argv=None) -> dict:
    result = train_hard(build_parser().parse_args(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
