"""Exponential moving average of parameters — the port of
`tngp/train/ema.py`.  The EMA state is a list of tensors aligned with the
parameter list; the update runs in place."""

from __future__ import annotations

from typing import Sequence

import torch


def ema_init(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Real copies: the live parameters are updated in place."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.95) -> None:
    """e <- e * decay + p * (1 - decay), in place."""
    torch._foreach_mul_(list(ema_params), decay)
    torch._foreach_add_(list(ema_params), [p.detach() for p in params], alpha=1.0 - decay)
