"""Instant-NGP NeRF entry point — the port of `tngp/cli/main_nerf.py`.

    python -m tngp_torch.cli.main_nerf <dataset dir | synthetic> [flags]

Trains on the card (the CPU with `TNGP_PLATFORM=cpu`) with checkpoints and
resume (`--ckpt latest`), validates, renders the test poses to PNG frames
and exports a mesh; `--test` renders and exports from the latest
checkpoint.  The flags and defaults are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    from .common import add_common_args, build_configs, check_ported, load_dataset, select_device

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--encoding", type=str, default="hashgrid_window",
                   choices=["hashgrid_window", "hashgrid", "tiledgrid"],
                   help="position encoder; the port has hashgrid_window")
    p.add_argument("--gui", action="store_true", help="launch the web viewer (not ported yet)")
    p.add_argument("--gui_port", type=int, default=7860)
    p.add_argument("--mesh_resolution", type=int, default=256)
    p.add_argument("--skip_test_render", action="store_true")
    opt = p.parse_args(argv)
    check_ported(opt)
    dev = select_device()

    from ..models import NGPNetwork
    from ..train import Trainer

    cfg, tc = build_configs(opt)
    os.makedirs(tc.workspace, exist_ok=True)
    model = NGPNetwork(
        bound=opt.bound,
        bg_radius=opt.bg_radius,
        encoding=opt.encoding,
        compute_dtype=torch.bfloat16 if tc.bf16 else torch.float32,
        device=dev,
        seed=tc.seed,
    )

    if opt.test:
        test_ds = load_dataset(opt, "test", dev)
        trainer = Trainer(model, test_ds, cfg, tc, device=dev)
        trainer.test(test_ds.poses)
        trainer.save_mesh(resolution=256, threshold=10.0)
        return trainer

    train_ds = load_dataset(opt, "train", dev)
    try:
        valid_ds = load_dataset(opt, "val", dev)
    except FileNotFoundError:
        valid_ds = None
    trainer = Trainer(model, train_ds, cfg, tc, valid_dataset=valid_ds, device=dev)

    steps_per_epoch = tc.steps_per_epoch or train_ds.num_frames
    max_epochs = int(np.ceil(opt.iters / steps_per_epoch))
    trainer.train(max_epochs)
    if valid_ds is not None:
        trainer.evaluate(valid_ds, write_images=True)
    if not opt.skip_test_render:
        try:
            test_ds = load_dataset(opt, "test", dev)
            trainer.test(test_ds.poses)
        except FileNotFoundError:
            pass
    trainer.save_mesh(resolution=opt.mesh_resolution, threshold=10.0)
    return trainer


if __name__ == "__main__":
    main()
