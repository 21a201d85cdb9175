"""Shared CLI plumbing — the port of `tngp/cli/common.py`: the same flags
and defaults (`add_common_args`), `build_configs` and `load_dataset`.

The card is used unless `TNGP_PLATFORM=cpu` asks for the CPU; there is no
fallback when no card is found.  Options the port has not ported yet raise
`NotImplementedError` naming their ROADMAP item (`check_ported`); none is
ignored.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..render import RenderConfig
from ..utils.config import TrainConfig


def select_device() -> torch.device:
    """`TNGP_PLATFORM=cpu` -> the CPU; otherwise the CUDA card, which must
    be there."""
    plat = os.environ.get("TNGP_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"TNGP_PLATFORM={plat!r}: the port runs on 'cpu' or the CUDA card")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible; set TNGP_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("path", type=str, help="dataset root (or 'synthetic')")
    p.add_argument("-O", action="store_true",
                   help="recommended settings: bf16 MLPs + occupancy grid (+preload, always on)")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test", action="store_true")
    # training
    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--max_steps", type=int, default=512,
                   help="ladder rungs per ray (reference used 1024 CUDA steps)")
    p.add_argument("--num_steps", type=int, default=128, help="uniform-path coarse steps")
    p.add_argument("--upsample_steps", type=int, default=128, help="uniform-path fine steps")
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--sample_budget", type=int, default=128,
                   help="K: per-ray sample budget (replaces mean_count)")
    p.add_argument("--march_group", type=int, default=8,
                   help="rungs per coarse-probe group (0 = flat march)")
    p.add_argument("--compact_fraction", type=float, default=0.25,
                   help="global sample budget as a fraction of num_rays*K "
                        "(the reference's mean_count semantics); 1.0 disables")
    p.add_argument("--no_march_dense", action="store_true",
                   help="disable the slab-free dense train march")
    p.add_argument("--march_chunk", type=int, default=8,
                   help="rungs per two-level march chunk on the dense path "
                        "(0 = flat probe-every-rung)")
    p.add_argument("--no_adaptive_budget", action="store_true",
                   help="disable the demand-adapted budget-tier ladder")
    p.add_argument("--no_adaptive_overdrive", action="store_true",
                   help="forbid the tier ladder from growing the budget above "
                        "compact_fraction when rays get dropped")
    p.add_argument("--profile", type=str, default="",
                   help="directory: profile the first epoch (not ported yet)")
    # model
    p.add_argument("--fp16", action="store_true", help="bf16 MLPs")
    # dataset
    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", action="store_true", help="always on (data lives on the card)")
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs=3, default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 128)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10.0)
    p.add_argument("--bg_radius", type=float, default=-1.0)
    p.add_argument("--downscale", type=int, default=1)
    # experimental
    p.add_argument("--no_grid", action="store_true",
                   help="uniform+importance sampling instead of the occupancy grid "
                        "(not ported yet)")
    p.add_argument("--error_map", action="store_true", help="not ported yet")
    p.add_argument("--rand_pose", type=int, default=-1,
                   help="> 0: every Nth step is a CLIP-guided random-pose step (not ported yet)")
    p.add_argument("--clip_text", type=str, default=None,
                   help="text prompt for CLIP guidance (not ported yet)")
    p.add_argument("--clip_model_path", type=str, default="openai/clip-vit-base-patch16",
                   help="local HF CLIP snapshot dir (not ported yet)")
    p.add_argument("--eval_interval", type=int, default=50)
    return p


def check_ported(opt) -> None:
    """Raise on every option whose path the port does not have yet."""
    unported = [
        (getattr(opt, "gui", False), "--gui", "queue 1 item 4 (cli/viewer.py)"),
        (opt.no_grid, "--no_grid", "queue 1 item 4 (use_grid=False training)"),
        (opt.error_map, "--error_map", "queue 1 item 4 (the error map)"),
        (opt.rand_pose > 0 or opt.clip_text is not None, "--rand_pose/--clip_text",
         "queue 1 item 13 (CLIP guidance)"),
        (getattr(opt, "encoding", "hashgrid_window") != "hashgrid_window",
         f"--encoding {getattr(opt, 'encoding', '')}", "queue 1 item 6 (the golden hash grid)"),
        (opt.bg_radius > 0, "--bg_radius > 0", "queue 1 item 5 (sph_from_ray and the bg model)"),
        (bool(opt.profile), "--profile", "queue 1 item 4 (--profile)"),
    ]
    for is_set, flag, item in unported:
        if is_set:
            raise NotImplementedError(f"{flag} is not ported to tngp_torch yet (ROADMAP.md {item})")


def build_configs(opt) -> tuple[RenderConfig, TrainConfig]:
    cfg = RenderConfig.from_bound(
        opt.bound,
        min_near=opt.min_near,
        dt_gamma=opt.dt_gamma,
        max_steps=opt.max_steps,
        K=opt.sample_budget,
        density_thresh=opt.density_thresh,
        bg_radius=opt.bg_radius,
        num_steps=opt.num_steps,
        upsample_steps=opt.upsample_steps,
        march_group=(
            opt.march_group
            if opt.march_group > 0
            and opt.max_steps % opt.march_group == 0
            and opt.sample_budget % opt.march_group == 0
            else 0
        ),
        compact_fraction=opt.compact_fraction,
        # the dense march needs an active global budget
        march_dense=(not opt.no_march_dense) and opt.compact_fraction < 1.0,
        march_chunk=(
            opt.march_chunk
            if opt.march_chunk > 0 and opt.max_steps % opt.march_chunk == 0
            else 0
        ),
    )
    tc = TrainConfig(
        workspace=opt.workspace,
        seed=opt.seed,
        iters=opt.iters,
        lr=opt.lr,
        num_rays=opt.num_rays,
        eval_interval=opt.eval_interval,
        update_extra_interval=opt.update_extra_interval,
        error_map=opt.error_map,
        patch_size=opt.patch_size,
        color_space=opt.color_space,
        bf16=bool(opt.fp16 or opt.O),
        use_checkpoint=opt.ckpt,
        rand_pose=getattr(opt, "rand_pose", -1),
        clip_text=getattr(opt, "clip_text", None),
        clip_model_path=getattr(opt, "clip_model_path", "openai/clip-vit-base-patch16"),
        profile_dir=getattr(opt, "profile", ""),
        adaptive_budget=not getattr(opt, "no_adaptive_budget", False),
        adaptive_overdrive=not getattr(opt, "no_adaptive_overdrive", False),
    )
    return cfg, tc


def load_dataset(opt, split: str, device="cuda"):
    """The split of the dataset at `opt.path`; 'synthetic' renders the blob
    scene on `device` (`TNGP_SYNTH=frames,H,W` sizes it, 16,128,128 by
    default) and serves it for every split."""
    from ..data.provider import NeRFDataset

    if opt.path == "synthetic":
        spec = os.environ.get("TNGP_SYNTH", "16,128,128").split(",")
        nf, H, W = (int(x) for x in spec)
        from ..data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(n_frames=nf, H=H, W=W, device=device)
    return NeRFDataset.load(
        opt.path, split=split, downscale=opt.downscale, scale=opt.scale,
        offset=tuple(opt.offset), use_error_map=opt.error_map,
    )
