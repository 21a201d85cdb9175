"""TensoRF entry point — the port of `tngp/cli/main_tensorf.py`.

    python -m tngp_torch.cli.main_tensorf <dataset dir | synthetic> [--cp] [flags]

Trains the VM TensoRF field (`--cp`: the CP decomposition, sigma rank 96,
colour rank 288) on the card (the CPU with `TNGP_PLATFORM=cpu`) from
`--resolution0`, shrinking and upsampling at each `--upsample_model_steps`
towards `--resolution1`, with checkpoints and resume (`--ckpt latest`,
across an upsample too), then evaluates the validation split and writes
its images; `--test` renders the training poses from the latest checkpoint
to PNG frames.  The flags and defaults are the JAX CLI's, its quirk
included: `--upsample_model_steps` appends to the five default milestones
(argparse's `append` action on a list default), so `--upsample_model_steps
20` trains with milestones (2000, 3000, 4000, 5500, 7000, 20).
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
    p.add_argument("--cp", action="store_true", help="use CP decomposition")
    p.add_argument("--resolution0", type=int, default=128)
    p.add_argument("--resolution1", type=int, default=300)
    p.add_argument("--upsample_model_steps", type=int, action="append",
                   default=[2000, 3000, 4000, 5500, 7000])
    p.add_argument("--l1_reg_weight", type=float, default=1e-4)
    opt = p.parse_args(argv)
    dev = select_device()

    from ..models import TensoRFNetwork
    from ..train import TensoRFTrainer

    cfg, tc = build_configs(opt)
    os.makedirs(tc.workspace, exist_ok=True)
    kw = dict(resolution=(opt.resolution0,) * 3, bound=opt.bound, bg_radius=opt.bg_radius,
              compute_dtype=torch.bfloat16 if tc.bf16 else torch.float32, device=dev,
              seed=tc.seed)
    if opt.cp:
        kw.update(decomposition="cp", sigma_rank=(96, 96, 96), color_rank=(288, 288, 288))
    model = TensoRFNetwork(**kw)

    train_ds = load_dataset(opt, "train", dev)
    try:
        valid_ds = load_dataset(opt, "val", dev)
    except FileNotFoundError:
        valid_ds = None
    trainer = TensoRFTrainer(
        model, train_ds, cfg, tc, valid_dataset=valid_ds, l1_reg_weight=opt.l1_reg_weight,
        upsample_model_steps=tuple(opt.upsample_model_steps), resolution1=opt.resolution1,
        device=dev)
    if opt.test:
        trainer.test(train_ds.poses)
        return trainer
    steps_per_epoch = tc.steps_per_epoch or train_ds.num_frames
    trainer.train(int(np.ceil(opt.iters / steps_per_epoch)))
    if valid_ds is not None:
        trainer.evaluate(valid_ds, write_images=True)
    return trainer


if __name__ == "__main__":
    main()
