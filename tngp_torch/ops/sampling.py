"""Hierarchical (inverse-CDF) importance sampling — the port of
`tngp/ops/sampling.py` `sample_pdf`."""

from __future__ import annotations

import torch


def sample_pdf(
    bins: torch.Tensor,  # [B, T] bin edges (old z values)
    weights: torch.Tensor,  # [B, T-1]
    n_samples: int,
    det: bool = False,
    u: torch.Tensor | None = None,  # [B, n_samples] uniforms in [0, 1)
) -> torch.Tensor:
    """Returns [B, n_samples] new z values drawn from the weight histogram.
    Where the JAX function takes a key, this one takes the uniforms `u`
    themselves."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, T]
    B, T = cdf.shape
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(B, n_samples)
    elif u is None:
        raise ValueError("u required when det=False")
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=T - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
