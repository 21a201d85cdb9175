"""Stream compositing over globally compacted samples — the port of the
`composite_stream` forward in `tngp/ops/composite.py` (`_stream_fwd_impl`).

Per ray segment of the ray-major sample stream:

  tau_i = sigma_i * dt_i * mask_i
  T_i   = exp(-segmented_cumsum_excl(tau))
  w_i   = T_i * (1 - exp(-tau_i)),   zeroed after the first sample whose
          running transmittance falls below T_thresh

and the per-ray sums of (w * rgb, w, w * t_cum) come from one scatter-add
(the port's kernel on the card).  The backward comes with training.
"""

from __future__ import annotations

import torch

from ..kernels.scatter import scatter_add


def _segmented_cumsum(vals: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Per-segment inclusive prefix sum along the last axis.

    A float32 `global cumsum - segment base` cancels catastrophically once
    the global prefix is ~1e4x the segment values (M ~ 393K samples); the
    JAX package uses a segmented associative scan.  Here the global cumsum
    runs in float64, so the subtraction keeps f32 accuracy, and the result
    is cast back."""
    v = vals.double()
    c = torch.cumsum(v, dim=-1)
    idx = torch.arange(vals.shape[-1], device=vals.device)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values  # segment head
    base = (c - v)[..., start]
    return (c - base).to(vals.dtype)


def composite_stream(
    sigmas: torch.Tensor,  # [M] compacted (ray-major order)
    rgbs_cf: torch.Tensor,  # [3, M]
    dts: torch.Tensor,  # [M]
    gaps: torch.Tensor | None,  # [M] real t advance; ignored if t_cum is given
    ray_id: torch.Tensor,  # [M] nondecreasing ray of each sample
    valid: torch.Tensor,  # [M] bool (False = padding slot)
    n_rays: int,
    T_thresh: float = 1e-4,
    t_cum: torch.Tensor | None = None,  # [M] advance since the ray start
):
    """Composite the compacted sample stream.  Returns (weights_sum [N],
    depth [N], image [N, 3])."""
    m = valid.float()
    rid = ray_id.long()
    is_start = torch.cat([rid.new_ones((1,), dtype=torch.bool), rid[1:] != rid[:-1]])
    if t_cum is None:
        t_cum = _segmented_cumsum(gaps.float() * m, is_start)
    else:
        t_cum = t_cum.float()
    sig = sigmas.float() * m
    tau = sig * dts.float()
    acc = _segmented_cumsum(tau, is_start)
    T_before = torch.exp(-(acc - tau))
    alpha = -torch.expm1(-tau)
    weights = T_before * alpha * m

    # early termination within each segment (the first stopper stays)
    T_after = torch.exp(-acc)
    stop_f = (T_after < T_thresh).float() * m
    stopped = _segmented_cumsum(stop_f, is_start)
    alive = ((stopped - stop_f) < 0.5).float()
    weights = weights * alive

    rgb = rgbs_cf.float()
    vals = torch.stack(
        [weights * rgb[0], weights * rgb[1], weights * rgb[2], weights, weights * t_cum],
        dim=1,
    )  # [M, 5]
    out = scatter_add(torch.clamp(rid, 0, n_rays - 1), vals, n_rays)  # [N, 5]
    return out[:, 3], out[:, 4], out[:, 0:3]
