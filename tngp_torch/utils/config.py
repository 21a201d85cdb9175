"""Typed experiment configuration — the fields of `tngp/utils/config.py`
`TrainConfig` that the NGP trainer of this port reads, with the same names
and defaults."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TrainConfig:
    name: str = "ngp"
    seed: int = 0
    iters: int = 30000  # total training steps (the lr decays to 0.1x over them)
    lr: float = 1e-2
    num_rays: int = 4096
    ema_decay: float = 0.95
    update_extra_interval: int = 16  # density grid update cadence (steps)
    steps_per_epoch: Optional[int] = None  # default: number of train frames
    # adapt the global sample budget to measured demand: a ladder of budget
    # tiers (fractions of the configured compact_fraction); the trainer moves
    # down when demand leaves headroom and up when rays get budget-dropped
    adaptive_budget: bool = True
    # let the ladder extend above the configured compact_fraction (to 2x,
    # capped at 0.9) while rays are being dropped
    adaptive_overdrive: bool = True
