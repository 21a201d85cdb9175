"""Transmittance compositing — the port of `tngp/ops/composite.py`:
`composite_stream` over globally compacted samples, with its closed-form
backward (`_composite_stream_core_bwd`), and the `[N, K]` slab compositors
`composite_weights`, `composite_rays_cf` (CCNeRF's step and the slab
training render), `composite_rays` (colours last) and `composite_rays_flat`
(`[N*K]`-flat samples), which plain autograd differentiates as XLA
differentiates the JAX functions.

Per ray segment of the ray-major sample stream:

  tau_i = sigma_i * dt_i * mask_i
  T_i   = exp(-segmented_cumsum_excl(tau))
  w_i   = T_i * (1 - exp(-tau_i)),   zeroed after the first sample whose
          running transmittance falls below T_thresh

and the per-ray sums of (w * rgb, w, w * t_cum) come from one scatter-add
over the ascending ray ids (on the card the deterministic segmented reduce,
`indices="sorted"`).  The ids must ascend over padding slots too: the
renderer gives the march's padding ray n_rays, which the reduction drops
and the scans and gathers clamp to n_rays - 1 (a padding slot's weight is
0 either way).  The backward needs one suffix segmented
sum and three gathers on the ray id:

  g_i     = dWs[r_i] + dD[r_i] * tcum_i + dIm[r_i, :] . rgb_i
  dtau_i  = T_after_i * m_i * alive_i * g_i - (S_i - w_i g_i),
              S_i = suffix_segsum(w g)_i
  dsig_i  = dtau_i * dt_i * m_i,   ddt_i = dtau_i * sig_i
  drgb_ci = w_i * dIm[r_i, c],     dtcum_i = w_i * dD[r_i]
"""

from __future__ import annotations

import torch

from ..kernels.scatter import scatter_add


def _segment_heads(is_start: torch.Tensor) -> torch.Tensor:
    """[M] bool segment starts -> [M] index of each element's segment head."""
    idx = torch.arange(is_start.shape[0], device=is_start.device)
    return torch.cummax(torch.where(is_start, idx, 0), dim=0).values


def _segmented_cumsum(vals: torch.Tensor, is_start: torch.Tensor,
                      heads: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment inclusive prefix sum along the last axis.

    A float32 `global cumsum - segment base` cancels catastrophically once
    the global prefix is ~1e4x the segment values (M ~ 393K samples); the
    JAX package uses a segmented associative scan.  Here the global cumsum
    runs in float64, so the subtraction keeps f32 accuracy, and the result
    is cast back.  `heads` (`_segment_heads(is_start)`) may be passed by a
    caller that scans several arrays over the same segments."""
    if heads is None:
        heads = _segment_heads(is_start)
    v = vals.double()
    c = torch.cumsum(v, dim=-1)
    base = (c - v)[..., heads]
    return (c - base).to(vals.dtype)


def _suffix_segsum(vals: torch.Tensor, is_end: torch.Tensor) -> torch.Tensor:
    """Per-segment inclusive SUFFIX sum along the last axis."""
    return _segmented_cumsum(vals.flip(-1), is_end.flip(0)).flip(-1)


def _stream_weights(sigmas, dts, m, is_start, heads, T_thresh):
    """Shared forward math: (sig, weights, T_after, alive)."""
    sig = sigmas.float() * m
    tau = sig * dts.float()
    acc = _segmented_cumsum(tau, is_start, heads)
    T_before = torch.exp(-(acc - tau))
    alpha = -torch.expm1(-tau)
    weights = T_before * alpha * m
    # early termination within each segment (the first stopper stays)
    T_after = torch.exp(-acc)
    stop_f = (T_after < T_thresh).float() * m
    stopped = _segmented_cumsum(stop_f, is_start, heads)
    alive = ((stopped - stop_f) < 0.5).float()
    return sig, weights * alive, T_after, alive


def _stream_vals(weights, rgb, t_cum):
    return torch.stack(
        [weights * rgb[0], weights * rgb[1], weights * rgb[2], weights, weights * t_cum],
        dim=1,
    )  # [M, 5]


class _CompositeStreamCore(torch.autograd.Function):
    """Stream compositor with the closed-form backward (module docstring)."""

    @staticmethod
    def forward(ctx, sigmas, rgbs_cf, dts, t_cum, rid, sid, m, is_start, heads, n_rays,
                T_thresh):
        sig, weights, T_after, alive = _stream_weights(sigmas, dts, m, is_start, heads,
                                                       T_thresh)
        rgb = rgbs_cf.float()
        t_cum = t_cum.float()
        # the unclamped ids: a padding slot's n_rays drops it (its weight is 0)
        out = scatter_add(sid, _stream_vals(weights, rgb, t_cum), n_rays,
                          indices="sorted")  # [N, 5]
        ctx.save_for_backward(rid, m, dts.float(), sig, t_cum, rgb, weights, T_after,
                              alive, is_start)
        ctx.dtypes = (sigmas.dtype, rgbs_cf.dtype, dts.dtype)
        return out[:, 3], out[:, 4], out[:, 0:3]

    @staticmethod
    def backward(ctx, dws, dd, dim):
        rid, m, dt, sig, t_cum, rgb, w, T_after, alive, is_start = ctx.saved_tensors
        sdt, rdt, ddt = ctx.dtypes
        dws_s = dws.float()[rid]
        dd_s = dd.float()[rid]
        dim_s = dim.float()[rid].T  # [3, M]
        g = dws_s + dd_s * t_cum + (dim_s * rgb).sum(dim=0)
        wg = w * g
        is_end = torch.cat([is_start[1:], is_start.new_ones((1,))])
        S = _suffix_segsum(wg, is_end)
        dtau = T_after * m * alive * g - (S - wg)
        dsig = (dtau * dt * m).to(sdt)
        d_dt = (dtau * sig).to(ddt)
        drgb = (w[None] * dim_s).to(rdt)
        dtc = w * dd_s
        return dsig, drgb, d_dt, dtc, None, None, None, None, None, None, None


def _stream_prologue(gaps, ray_id, valid, n_rays, t_cum):
    m = valid.float()
    rid = torch.clamp(ray_id.long(), 0, n_rays - 1)
    is_start = torch.cat([rid.new_ones((1,), dtype=torch.bool), rid[1:] != rid[:-1]])
    heads = _segment_heads(is_start)  # once per call, shared by every scan
    if t_cum is None:
        t_cum = _segmented_cumsum(gaps.float() * m, is_start, heads)
    else:
        t_cum = t_cum.float()
    return m, rid, is_start, heads, t_cum


def composite_stream(
    sigmas: torch.Tensor,  # [M] compacted (ray-major order)
    rgbs_cf: torch.Tensor,  # [3, M]
    dts: torch.Tensor,  # [M]
    gaps: torch.Tensor | None,  # [M] real t advance; ignored if t_cum is given
    ray_id: torch.Tensor,  # [M] nondecreasing ray of each sample; n_rays on padding
    valid: torch.Tensor,  # [M] bool (False = padding slot)
    n_rays: int,
    T_thresh: float = 1e-4,
    t_cum: torch.Tensor | None = None,  # [M] advance since the ray start
):
    """Composite the compacted sample stream.  Returns (weights_sum [N],
    depth [N], image [N, 3]).  Gradients flow to `sigmas`, `rgbs_cf`, `dts`
    and `t_cum` (or `gaps`) through the closed-form backward."""
    m, rid, is_start, heads, t_cum = _stream_prologue(gaps, ray_id, valid, n_rays, t_cum)
    return _CompositeStreamCore.apply(
        sigmas, rgbs_cf, dts, t_cum, rid, ray_id.long(), m, is_start, heads, n_rays,
        float(T_thresh)
    )


def composite_stream_ref(sigmas, rgbs_cf, dts, gaps, ray_id, valid, n_rays: int,
                         T_thresh: float = 1e-4, t_cum=None):
    """Twin of `composite_stream` that torch differentiates by itself (the
    scans and an `index_add_` reduction) — the gradient oracle of the
    closed-form backward; the render paths never call it."""
    m, rid, is_start, heads, t_cum = _stream_prologue(gaps, ray_id, valid, n_rays, t_cum)
    _, weights, _, _ = _stream_weights(sigmas, dts, m, is_start, heads, float(T_thresh))
    vals = _stream_vals(weights, rgbs_cf.float(), t_cum)
    out = torch.zeros((n_rays, 5), dtype=torch.float32, device=vals.device)
    out = out.index_add(0, rid, vals)
    return out[:, 3], out[:, 4], out[:, 0:3]


def composite_weights(sigmas: torch.Tensor, dts: torch.Tensor, mask: torch.Tensor,
                      T_thresh: float = 1e-4) -> torch.Tensor:
    """Per-sample weights `T_i * alpha_i` over `[N, K]` slabs, zeroed after
    the first sample whose running transmittance falls below `T_thresh`
    (that sample keeps its weight)."""
    m = mask.float()
    tau = sigmas.float() * dts.float() * m
    acc = torch.cumsum(tau, dim=-1)  # inclusive
    T_before = torch.exp(-(acc - tau))
    alpha = -torch.expm1(-tau)
    weights = T_before * alpha * m
    stop = (torch.exp(-acc) < T_thresh).float()
    alive = (torch.cumsum(stop, dim=-1) - stop) < 0.5  # exclusive: the first stopper stays
    return weights * alive.float()


def composite_rays_cf(sigmas: torch.Tensor, rgbs_cf: torch.Tensor, dts: torch.Tensor,
                      gaps: torch.Tensor, mask: torch.Tensor, T_thresh: float = 1e-4):
    """Slab compositor, channels first: sigmas, dts, gaps, mask [N, K],
    rgbs_cf [3, N, K].  Returns (weights_sum [N], depth [N], image [N, 3],
    weights [N, K]); depth sums `w_i * sum_{j<=i} gap_j`."""
    weights = composite_weights(sigmas, dts, mask, T_thresh)
    t_cum = torch.cumsum(gaps.float() * mask.float(), dim=-1)
    weights_sum = weights.sum(dim=-1)
    depth = (weights * t_cum).sum(dim=-1)
    image = torch.einsum("nk,cnk->nc", weights, rgbs_cf.float())
    return weights_sum, depth, image, weights


def composite_rays(sigmas: torch.Tensor, rgbs: torch.Tensor, dts: torch.Tensor,
                   gaps: torch.Tensor, mask: torch.Tensor, T_thresh: float = 1e-4):
    """`composite_rays_cf` with the colours last, rgbs [N, K, 3]."""
    return composite_rays_cf(sigmas, rgbs.movedim(-1, 0), dts, gaps, mask, T_thresh)


def composite_rays_flat(sigmas: torch.Tensor, rgbs: torch.Tensor, dts: torch.Tensor,
                        gaps: torch.Tensor, mask: torch.Tensor, T_thresh: float = 1e-4):
    """`composite_rays` on `[N*K]`-flat samples (rgbs [N*K, 3]) with the
    slab's mask [N, K]."""
    N, K = mask.shape
    return composite_rays(sigmas.reshape(N, K), rgbs.reshape(N, K, 3), dts.reshape(N, K),
                          gaps.reshape(N, K), mask, T_thresh)
