"""CCNeRF entry point — the port of `tngp/cli/main_ccnerf.py`.

    python -m tngp_torch.cli.main_ccnerf <dataset dir | synthetic> [flags]
    python -m tngp_torch.cli.main_ccnerf <dataset dir | synthetic> --compose [flags]

Trains the rank-residual CCNeRF field (`CCConfig(bound=--bound)`, Adam at
`--lr1` for the factors and `--lr2` for the projections) on the card (the
CPU with `TNGP_PLATFORM=cpu`) with checkpoints and resume (`--ckpt
latest`), then finalizes it and writes `<workspace>/cc_models/full.pkl` and
one compressed model per `--rank_levels` level (`rank_dv_dm_cv_cm.pkl`),
printing each level's parameter count.  `--compose` reads every model in
`cc_models/` (the JAX package's files too) and builds the demo scene:
object i rotated by 0.7 i about y, scaled by 1 / (1 + 0.3 i) and shifted
by 0.4 i - 0.4 along x.  The flags and defaults are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def compose_scene(workspace: str, device) -> "CCScene":  # noqa: F821
    """The demo scene of the models in `<workspace>/cc_models/`, in file
    name order."""
    from ..models.ccnerf import CCScene, load_cc_model

    scene = CCScene(device=device)
    base = os.path.join(workspace, "cc_models")
    for i, fname in enumerate(sorted(os.listdir(base))):
        params, ccfg = load_cc_model(os.path.join(base, fname))
        ang = 0.7 * i
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        scene.add(params, ccfg, R=R, s=1.0 / (1 + 0.3 * i),
                  t=np.array([0.4 * i - 0.4, 0, 0], np.float32))
    return scene


def cc_config(opt):
    """The object's structure: `CCConfig`'s defaults at `--bound`."""
    from ..models.ccnerf import CCConfig

    return CCConfig(bound=opt.bound)


def main(argv=None):
    from .common import add_common_args, build_configs, load_dataset, select_device

    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--compose", action="store_true")
    p.add_argument("--lr1", type=float, default=2e-2)
    p.add_argument("--lr2", type=float, default=1e-3)
    p.add_argument("--rank_levels", type=str,
                   default="8,0,8,0;16,2,16,2;32,4,32,16;64,8,64,32;64,16,64,64",
                   help="semicolon-separated (dv,dm,cv,cm) compression levels")
    opt = p.parse_args(argv)
    dev = select_device()

    from ..models.ccnerf import cc_compress, cc_finalize, count_params, save_cc_model
    from ..train import CCTrainer

    cfg, tc = build_configs(opt)
    cc_cfg = cc_config(opt)

    if opt.compose:
        scene = compose_scene(opt.workspace, dev)
        print(f"[compose] {len(scene.objects)} objects")
        return scene

    os.makedirs(tc.workspace, exist_ok=True)
    train_ds = load_dataset(opt, "train", dev)
    trainer = CCTrainer(cc_cfg, train_ds, cfg, tc, lr1=opt.lr1, lr2=opt.lr2, device=dev)
    steps_per_epoch = tc.steps_per_epoch or train_ds.num_frames
    trainer.train(int(np.ceil(opt.iters / steps_per_epoch)))

    # finalize + multi-level compression (main_CCNeRF.py:206-228)
    fparams, fcfg = cc_finalize(trainer.model.numpy_params(), trainer.cc_cfg)
    out_dir = os.path.join(opt.workspace, "cc_models")
    os.makedirs(out_dir, exist_ok=True)
    save_cc_model(os.path.join(out_dir, "full.pkl"), fparams, fcfg)
    for level in opt.rank_levels.split(";"):
        ranks = tuple(int(t) for t in level.split(","))
        cparams, ccfg = cc_compress(fparams, fcfg, ranks)
        save_cc_model(os.path.join(out_dir, f"rank_{'_'.join(map(str, ranks))}.pkl"),
                      cparams, ccfg)
        print(f"[compress] ranks={ranks} params={count_params(cparams)}")
    return trainer


if __name__ == "__main__":
    main()
