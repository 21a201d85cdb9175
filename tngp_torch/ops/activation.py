"""`trunc_exp` — the port of `tngp/ops/activation.py` (forward only on the
eval path: exp(x); the clamped backward comes with training)."""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)
