"""D-NeRF entry point — the port of `tngp/cli/main_dnerf.py`.

    python -m tngp_torch.cli.main_dnerf <dataset dir | synthetic> [flags]

Trains the deformation-field D-NeRF (`--basis`: the temporal-basis variant,
`--hyper`: the ambient-dimension variant) on the card (the CPU with
`TNGP_PLATFORM=cpu`) over a time grid of `--time_size` slices updated every
100 steps, with checkpoints and resume (`--ckpt latest`), then evaluates
the validation split at each frame's time; `--test` renders the training
poses from the latest checkpoint to PNG frames; `--gui` serves the web
viewer with its time slider on `--gui_port` instead of training.  The
dataset's frames carry a `time` in [0, 1] (`transforms_*.json`).  The
flags and defaults are the JAX CLI's; as in the JAX package, D-NeRF's
step neither samples by nor updates the error map, and `--no_grid` has no
D-NeRF path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    from .common import add_common_args, build_configs, load_dataset, select_device

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--time_size", type=int, default=64)
    p.add_argument("--deform_reg", type=float, default=1e-3)
    p.add_argument("--gui", action="store_true",
                   help="launch the web viewer with a time slider")
    p.add_argument("--gui_port", type=int, default=7860)
    p.add_argument("--basis", action="store_true", help="temporal-basis variant")
    p.add_argument("--hyper", action="store_true", help="ambient-dimension variant")
    opt = p.parse_args(argv)
    if opt.basis and opt.hyper:
        p.error("--basis and --hyper are mutually exclusive")
    dev = select_device()

    from ..models import DNeRFBasisNetwork, DNeRFHyperNetwork, DNeRFNetwork
    from ..train import DNeRFTrainer

    cfg, tc = build_configs(opt)
    os.makedirs(tc.workspace, exist_ok=True)
    cls = (DNeRFBasisNetwork if opt.basis
           else DNeRFHyperNetwork if opt.hyper else DNeRFNetwork)
    model = cls(bound=opt.bound, bg_radius=opt.bg_radius,
                compute_dtype=torch.bfloat16 if tc.bf16 else torch.float32,
                device=dev, seed=tc.seed)
    train_ds = load_dataset(opt, "train", dev, with_time=True)
    try:
        valid_ds = load_dataset(opt, "val", dev, with_time=True)
    except FileNotFoundError:
        valid_ds = None
    trainer = DNeRFTrainer(model, train_ds, cfg, tc, valid_dataset=valid_ds,
                           time_size=opt.time_size, deform_reg=opt.deform_reg,
                           update_interval=100, device=dev)
    if opt.gui:
        from .viewer import run_viewer

        run_viewer(trainer, port=opt.gui_port)
        return trainer
    if opt.test:
        trainer.test(train_ds.poses)
        return trainer
    steps_per_epoch = tc.steps_per_epoch or train_ds.num_frames
    trainer.train(int(np.ceil(opt.iters / steps_per_epoch)))
    if valid_ds is not None:
        trainer.evaluate(valid_ds)
    return trainer


if __name__ == "__main__":
    main()
