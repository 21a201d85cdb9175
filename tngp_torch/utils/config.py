"""Typed experiment configuration — `tngp/utils/config.py` `TrainConfig`,
with the same names and defaults.  Options the port does not honour yet
raise when they are set to other than their defaults; none is ignored."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# option -> (its default, the ROADMAP queue 1 item that ports it)
_NOT_PORTED = {
    "error_map": (False, "item 4 (the error map)"),
    "rand_pose": (-1, "item 13 (CLIP guidance)"),
    "clip_text": (None, "item 13 (CLIP guidance)"),
    "clip_model_path": ("openai/clip-vit-base-patch16", "item 13 (CLIP guidance)"),
    "profile_dir": ("", "item 4 (--profile)"),
}


@dataclass(frozen=True)
class TrainConfig:
    name: str = "ngp"
    workspace: str = "workspace"
    seed: int = 0
    iters: int = 30000  # total training steps (the lr decays to 0.1x over them)
    lr: float = 1e-2
    num_rays: int = 4096
    eval_interval: int = 50  # epochs
    max_keep_ckpt: int = 2
    ema_decay: float = 0.95
    update_extra_interval: int = 16  # density grid update cadence (steps)
    error_map: bool = False
    patch_size: int = 1
    color_space: str = "srgb"  # 'srgb' | 'linear'
    bf16: bool = True  # bf16 MLPs (the CLI's -O / --fp16)
    use_checkpoint: str = "latest"  # 'latest' | 'scratch' | a path
    steps_per_epoch: Optional[int] = None  # default: number of train frames
    # CLIP-guided training: every `rand_pose`-th step; <= 0 disables
    rand_pose: int = -1
    clip_text: Optional[str] = None
    clip_model_path: str = "openai/clip-vit-base-patch16"
    profile_dir: str = ""  # non-empty: profile the first epoch into it
    # adapt the global sample budget to measured demand: a ladder of budget
    # tiers (fractions of the configured compact_fraction); the trainer moves
    # down when demand leaves headroom and up when rays get budget-dropped
    adaptive_budget: bool = True
    # let the ladder extend above the configured compact_fraction (to 2x,
    # capped at 0.9) while rays are being dropped
    adaptive_overdrive: bool = True

    def __post_init__(self):
        for name, (default, item) in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r}: not ported yet "
                    f"(ROADMAP.md queue 1, {item})")
        if self.color_space not in ("srgb", "linear"):
            raise ValueError(f"color_space must be 'srgb' or 'linear', not {self.color_space!r}")
