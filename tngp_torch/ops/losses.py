"""Loss functions — the port of `tngp/ops/losses.py` (torch-ngp `loss.py`:
`mape_loss`, `huber_loss` and the O(N) mip-360 distortion loss
`eff_distloss`, whose gradient autograd takes through the cumsums, as the
JAX package leaves it to XLA)."""

from __future__ import annotations

import torch


def mape_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    loss = (pred - target).abs() / (target.abs() + 1e-2)
    return loss.mean() if reduction == "mean" else loss


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1,
               reduction: str = "mean") -> torch.Tensor:
    rel = (pred - target).abs()
    sqr = 0.5 / delta * rel * rel
    loss = torch.where(rel > delta, rel - 0.5 * delta, sqr)
    return loss.mean() if reduction == "mean" else loss


def eff_distloss(w: torch.Tensor, m: torch.Tensor, interval) -> torch.Tensor:
    """Distortion loss over per-ray sample weights `w` and midpoint
    distances `m` [B, N]; `interval` a scalar or [B, N]."""
    wm = w * m
    w_prefix = torch.cumsum(w, dim=-1) - w
    wm_prefix = torch.cumsum(wm, dim=-1) - wm
    n_rays = w[..., 0].numel()
    loss_uni = (1.0 / 3.0) * interval * w**2
    loss_bi = 2.0 * w * (m * w_prefix - wm_prefix)
    return (loss_bi.sum() + loss_uni.sum()) / n_rays
