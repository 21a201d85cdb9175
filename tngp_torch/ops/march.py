"""Occupancy-grid ray marching with static shapes — the port of
`tngp/ops/march.py`'s chunked march (`march_rays_chunked`, `ladder_samples`
and the helpers they use) and of its slab march `march_rays` (without
`group`: CCNeRF's step), which compacts each ray's first K occupied rungs
into an `[N, K]` slab.

The ladder: every ray visits the same deterministic rungs

    t_{j+1} = t_j + clamp(t_j * dt_gamma, dt_min, dt_max)

whose closed form (`_t_ladder`) is evaluated for all rungs in parallel.  The
chunked march probes G-rung chunk midpoints against a dilated occupancy
grid, fine-probes only the candidate chunks and emits the first `M_budget`
valid samples in flat (ray-major) order.  For the same inputs its integer
outputs (`sel`, `sel_valid`, `m_eff`, `ray_mask`, `num_points`; the slab
march's `mask`, `counts` and selected rungs) equal the JAX package's exactly; the float arithmetic follows the JAX expressions
operation by operation so that the occupancy probes agree bit for bit.

Indices are int64 here (int32 in the JAX package); the values are equal.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .grid_utils import bitfield_probe

SQRT3 = math.sqrt(3.0)


def _t_ladder(t0: torch.Tensor, j: torch.Tensor, dt_gamma: float, dt_min: float,
              dt_max: float) -> torch.Tensor:
    """t at ladder rung j.  t0 [N]; j [S] shared or [N, S] per ray -> [N, S]."""
    t0 = t0[:, None].float()
    jf = j.float()
    if jf.dim() == 1:
        jf = jf[None, :]
    if dt_gamma <= 0.0:
        return t0 + jf * dt_min
    a = dt_min / dt_gamma
    b = dt_max / dt_gamma
    lg = math.log(1.0 + dt_gamma)
    n1 = torch.ceil(torch.clamp(a - t0, min=0.0) / dt_min)
    tA = t0 + n1 * dt_min
    n2 = torch.ceil(torch.clamp(torch.log(torch.clamp(b / tA, min=1.0)), min=0.0) / lg)
    tB = tA * torch.exp(n2 * lg)
    k = jf
    t_p1 = t0 + k * dt_min
    t_p2 = tA * torch.exp((k - n1) * lg)
    t_p3 = tB + (k - n1 - n2) * dt_max
    return torch.where(k < n1, t_p1, torch.where(k < n1 + n2, t_p2, t_p3))


def _dts(ts: torch.Tensor, dt_gamma: float, dt_min: float, dt_max: float):
    if dt_gamma > 0:
        return torch.clamp(ts * dt_gamma, dt_min, dt_max)
    return torch.full_like(ts, dt_min)


def _float_exponent(x: torch.Tensor) -> torch.Tensor:
    """frexp-style exponent: x = m * 2^e with m in [0.5, 1)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 126


def mip_level_from_max(mx: torch.Tensor, dt: torch.Tensor, cascades: int,
                       grid_size: int) -> torch.Tensor:
    """Cascade level from max |coord| (raymarching.cu:42-54); constant 0
    when there is one cascade."""
    if cascades == 1:
        return torch.zeros(mx.shape, dtype=torch.int64, device=mx.device)
    e_pos = torch.where(mx > 0, _float_exponent(torch.clamp(mx, min=1e-30)), -100)
    mdt = dt * grid_size * 0.5
    e_dt = torch.where(mdt > 0, _float_exponent(torch.clamp(mdt, min=1e-30)), -100)
    return torch.clamp(torch.maximum(e_pos, e_dt), 0, cascades - 1).long()


def _to_index(x: torch.Tensor, H: int) -> torch.Tensor:
    """clip(x, 0, H-1) cast to int64, with NaN sent to 0.  A NaN coordinate
    (an infinite t times a zero direction component: missed or padding rays)
    gives a garbage index in the JAX package, where the gather fills and a
    later `t < far` test masks the result; here the index must stay in
    range, and the same test masks it."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, float(H - 1)).long()


def grid_cell_index_comp(px, py, pz, level: torch.Tensor, bound: float,
                         cascades: int, grid_size: int) -> torch.Tensor:
    """Linear cell index `level*H^3 + ((ix*H)+iy)*H + iz`, componentwise."""
    H = grid_size
    inv_mip_bound = 1.0 / torch.clamp(torch.exp2(level.float()), max=bound)

    def cell(p):
        return _to_index(0.5 * (p * inv_mip_bound + 1.0) * H, H)

    lin = (cell(px) * H + cell(py)) * H + cell(pz)
    return level.long() * (H**3) + lin


def _coarse_cascade_map(b_c: float, bound: float, hc: int) -> np.ndarray:
    """[hc, hc] 0/1 map of cascade-cube cells (cube [-b_c, b_c]) onto global
    cells (cube [-bound, bound]): entry (i, j) = 1 iff the intervals overlap."""
    M = np.zeros((hc, hc), np.float32)
    w_c = 2.0 * b_c / hc
    for i in range(hc):
        x0 = -b_c + i * w_c
        x1 = x0 + w_c
        g0 = int(np.floor((x0 + bound) / (2.0 * bound) * hc + 1e-6))
        g1 = int(np.ceil((x1 + bound) / (2.0 * bound) * hc - 1e-6)) - 1
        M[i, max(0, g0): min(hc, g1 + 1)] = 1.0
    return M


def build_dilated_cell_grid(bitfield: torch.Tensor, *, bound: float,
                            cascades: int, grid_size: int,
                            dilate: int) -> torch.Tensor:
    """Cascade-union occupancy at full resolution, max-pool dilated by
    `dilate` cells per axis.  Returns flat [H^3] bool over [-bound, bound]."""
    H = grid_size
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    bits = (bitfield.to(torch.int32)[:, None] >> shifts) & 1
    bits = bits.reshape(cascades, H, H, H).float()
    g = torch.zeros((H, H, H), dtype=torch.float32, device=bitfield.device)
    for cas in range(cascades):
        b_c = min(2.0**cas, bound)
        if b_c >= bound:
            g = g + bits[cas]
        else:
            M = torch.as_tensor(_coarse_cascade_map(b_c, bound, H), device=g.device)
            g = g + torch.einsum("ijk,ia,jb,kc->abc", bits[cas], M, M, M)
    w = 2 * dilate + 1
    g = g[None, None]
    for axis in range(3):
        win = tuple(w if a == axis else 1 for a in range(3))
        pad = tuple(dilate if a == axis else 0 for a in range(3))
        g = F.max_pool3d(g, kernel_size=win, stride=1, padding=pad)
    return (g[0, 0] > 0.5).reshape(-1)


def chunk_dilate(G: int, max_steps: int, grid_size: int, bound: float) -> int:
    """Dilation radius (cells) that march_rays_chunked needs for chunk size G."""
    dt_min = 2.0 * SQRT3 / max_steps
    cell = 2.0 * bound / grid_size
    return max(1, int(math.ceil(0.5 * (G - 1) * dt_min / cell)))


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.nonzero(mask, size=size, fill_value=fill_value)` for a flat bool
    mask, without a host sync: the cumulative count places each set element,
    and everything past `size` lands in a spare slot that is cut off."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.long(), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill_value, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, device=mask.device))
    return out[:size]


class ChunkedMarch(NamedTuple):
    """Result of march_rays_chunked."""

    sel: torch.Tensor  # [M_budget] flat (ray*S + rung) indices, ascending
    sel_valid: torch.Tensor  # [M_budget] bool
    m_eff: torch.Tensor  # [] number of real samples selected
    ray_mask: torch.Tensor  # [N] bool: ray kept ALL its valid samples
    num_points: torch.Tensor  # [] valid rungs in considered chunks
    t0: torch.Tensor  # [N] noise-shifted ladder origin
    resume_t: torch.Tensor  # [N] t just past the last selected sample


def _binary_search(n: int, size: int, go_right_fn, device) -> torch.Tensor:
    """Branch-free lower bound: for each of n queries, the first index in
    [0, size] where go_right_fn(mid) turns False."""
    lo = torch.zeros((n,), dtype=torch.int64, device=device)
    hi = torch.full((n,), size, dtype=torch.int64, device=device)
    for _ in range(max(1, size.bit_length())):
        mid = (lo + hi) >> 1
        go_right = go_right_fn(mid)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def march_rays_chunked(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    t_start: torch.Tensor,  # [N]
    fars: torch.Tensor,  # [N]
    bitfield: torch.Tensor,
    *,
    bound: float,
    cascades: int,
    grid_size: int,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    M_budget: int,
    G: int = 8,
    chunk_budget: int | None = None,
    noise: torch.Tensor | None = None,
    dilated_grid: torch.Tensor | None = None,
    ladder_steps: int | None = None,
    ray_chunk_cap: int | None = None,
) -> ChunkedMarch:
    """Two-level march + compaction in one pass (see the JAX docstring at
    tngp/ops/march.py:526-546 for the exact-prefix contract, the ladder
    window `ladder_steps` and the per-ray live-chunk cap `ray_chunk_cap`)."""
    dev = rays_o.device
    N = rays_o.shape[0]
    S = max_steps
    S_lad = S if ladder_steps is None else min(ladder_steps, S)
    if S % G or S_lad % G:
        raise ValueError(f"max_steps {S} / ladder_steps {S_lad} must be "
                         f"multiples of chunk size {G}")
    NCr = S_lad // G
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / grid_size
    cell = 2.0 * bound / grid_size
    dilate = chunk_dilate(G, max_steps, grid_size, bound)

    o = rays_o.float()
    d = rays_d.float()
    t0 = t_start.float()
    if noise is not None:
        dt0 = torch.clamp(t0 * dt_gamma, dt_min, dt_max)
        t0 = t0 + dt0 * noise.float()
    fars = fars.float()

    if dilated_grid is None:
        grid = build_dilated_cell_grid(
            bitfield, bound=bound, cascades=cascades, grid_size=grid_size,
            dilate=dilate,
        )
    else:
        grid = dilated_grid

    # ---- coarse stage: one dilated-grid probe per chunk midpoint ----------
    jg = torch.arange(NCr, device=dev) * G
    t_lo = _t_ladder(t0, jg, dt_gamma, dt_min, dt_max)  # [N, NCr]
    t_hi = _t_ladder(t0, jg + (G - 1), dt_gamma, dt_min, dt_max)
    tc = 0.5 * (t_lo + t_hi)
    halfext = 0.5 * (t_hi - t_lo)
    H = grid_size
    cix = []
    for c in range(3):
        p = torch.clamp(o[:, c:c + 1] + tc * d[:, c:c + 1], -bound, bound)
        cix.append(_to_index(torch.floor((p + bound) / (2.0 * bound) * H), H))
    ccell = (cix[0] * H + cix[1]) * H + cix[2]
    live = grid[ccell.reshape(-1)].reshape(N, NCr)
    live = live | (halfext > dilate * cell + 1e-6)
    live = live & (t_lo < fars[:, None])

    if ray_chunk_cap is not None:
        lrank = torch.cumsum(live.long(), dim=1)  # [N, NCr]
        cap_cut = lrank[:, -1] > ray_chunk_cap
        cut1 = live & (lrank == ray_chunk_cap + 1)
        j_cut = torch.argmax(cut1.to(torch.uint8), dim=1)  # first cut chunk
        t_cut = torch.gather(t_lo, 1, j_cut[:, None])[:, 0]
        live = live & (lrank <= ray_chunk_cap)
    else:
        cap_cut = torch.zeros((N,), dtype=torch.bool, device=dev)

    # ---- chunk selection ---------------------------------------------------
    if chunk_budget is None:
        chunk_budget = -(-3 * M_budget // G)
    CB = min(N * NCr, -(-chunk_budget // 128) * 128)
    flat_live = live.reshape(-1)
    csel = nonzero_static(flat_live, CB, N * NCr - 1)
    n_live = flat_live.sum()
    slot_ok = torch.arange(CB, device=dev) < n_live  # [CB]

    # ---- fine stage: exact ladder + bitfield probe on candidates only -----
    cray = csel // NCr  # [CB] nondecreasing
    jc = (csel - cray * NCr)[:, None] * G + torch.arange(G, device=dev)  # [CB, G]
    ts = _t_ladder(t0[cray], jc, dt_gamma, dt_min, dt_max)  # [CB, G]
    dts = _dts(ts, dt_gamma, dt_min, dt_max)
    oc = o[cray]
    dc = d[cray]
    px = torch.clamp(oc[:, 0:1] + ts * dc[:, 0:1], -bound, bound)
    py = torch.clamp(oc[:, 1:2] + ts * dc[:, 1:2], -bound, bound)
    pz = torch.clamp(oc[:, 2:3] + ts * dc[:, 2:3], -bound, bound)
    mx = torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs()))
    lvl = mip_level_from_max(mx, dts, cascades, grid_size)
    ccells = grid_cell_index_comp(px, py, pz, lvl, bound, cascades, grid_size)
    occ = bitfield_probe(bitfield, ccells.reshape(-1)).reshape(CB, G)
    cand = occ & (ts < fars[cray][:, None]) & slot_ok[:, None]

    # ---- sample selection --------------------------------------------------
    cand_flat = cand.reshape(-1)
    ccum = torch.cumsum(cand_flat.long(), 0)  # [CB*G] inclusive
    total = ccum[-1]
    m_eff = torch.clamp(total, max=M_budget)
    s2 = nonzero_static(cand_flat, M_budget, 0)
    csel_s = csel[s2 // G]
    ray_s = csel_s // NCr
    sel = ray_s * S + (csel_s - ray_s * NCr) * G + (s2 % G)
    sel = torch.clamp(sel, max=N * S - 1)
    want = torch.arange(1, M_budget + 1, device=dev)

    # ---- per-ray totals: binary search over the nondecreasing cray --------
    nq = torch.arange(N, device=dev)

    def ray_go_right(mid):
        m = torch.clamp(mid, max=CB - 1)
        return (cray[m] <= nq) & slot_ok[m] & (mid < CB)

    lo = _binary_search(N, CB, ray_go_right, dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    cum_counts = torch.where(lo > 0, ccum[torch.clamp(lo * G - 1, 0, CB * G - 1)], zero)
    g_trunc = (lo >= CB) & (n_live > CB)
    truncated = g_trunc | cap_cut
    ray_mask = (cum_counts <= m_eff) & ~truncated

    # ---- eval resume: t just past each ray's last selected sample ---------
    counts = cum_counts - torch.cat([cum_counts.new_zeros(1), cum_counts[:-1]])
    base = cum_counts - counts
    taken = torch.minimum(torch.clamp(m_eff - base, min=0), counts)
    has_drop = (taken < counts) | truncated
    cend = ccum.reshape(CB, G)[:, -1]  # [CB] inclusive valid count per chunk
    want_rank = torch.clamp(base + taken, min=1)

    def chunk_go_right(mid):
        return (cend[torch.clamp(mid, max=CB - 1)] < want_rank) & (mid < CB)

    cidx = torch.clamp(_binary_search(N, CB, chunk_go_right, dev), max=CB - 1)
    cflags = cand[cidx]  # [N, G]
    prev = cend[cidx] - cflags.sum(dim=1)
    in_rank = torch.cumsum(cflags.long(), dim=1) + prev[:, None]
    hit = cflags & (in_rank == want_rank[:, None])
    g_off = torch.argmax(hit.to(torch.uint8), dim=1)
    rung = (csel[cidx] - cray[cidx] * NCr) * G + g_off
    t_sel_last = _t_ladder(t0, rung[:, None], dt_gamma, dt_min, dt_max)[:, 0]
    dt_sel = _dts(t_sel_last, dt_gamma, dt_min, dt_max)
    t_after = torch.where(taken > 0, t_sel_last + dt_sel, t0)
    last = torch.full((N, 1), S_lad - 1, device=dev)
    t_last = _t_ladder(t0, last, dt_gamma, dt_min, dt_max)[:, 0]
    ladder_end = t_last + _dts(t_last, dt_gamma, dt_min, dt_max)
    resume_t = torch.minimum(torch.where(has_drop, t_after, ladder_end), fars)
    if ray_chunk_cap is not None:
        no_take = cap_cut & (counts == 0) & ~g_trunc
        resume_t = torch.where(no_take, torch.minimum(t_cut, fars), resume_t)

    return ChunkedMarch(
        sel=sel,
        sel_valid=want <= m_eff,
        m_eff=m_eff,
        ray_mask=ray_mask,
        num_points=total,
        t0=t0,
        resume_t=resume_t,
    )


def ladder_samples(
    sel: torch.Tensor,  # [M] flat (ray*S + rung) indices
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    t0: torch.Tensor,  # [N] ladder origin
    *,
    bound: float,
    cascades: int,
    grid_size: int,
    dt_gamma: float,
    max_steps: int,
):
    """Per-sample geometry of compacted slots from the closed-form ladder.

    Returns (ray_id [M], x_cf [3, M], d_cf [3, M], dt [M], t_rel [M]) with
    t_rel = t + dt - t0[ray], the telescoped advance the compositor uses for
    depth."""
    S = max_steps
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / grid_size
    sel = sel.long()
    ray_id = sel // S
    rung = sel - ray_id * S
    t0s = t0[ray_id]
    t = _t_ladder(t0s, rung.reshape(-1, 1), dt_gamma, dt_min, dt_max)[:, 0]
    dt = _dts(t, dt_gamma, dt_min, dt_max)
    od = torch.cat([rays_o.float(), rays_d.float()], dim=1).T  # [6, N]
    ods = od[:, ray_id]  # [6, M]
    o_cf, d_cf = ods[:3], ods[3:]
    x_cf = torch.clamp(o_cf + t[None, :] * d_cf, -bound, bound)
    t_rel = t + dt - t0s
    return ray_id, x_cf, d_cf, dt, t_rel


class MarchResult(NamedTuple):
    """Result of the slab march `march_rays`: channels-first positions and
    directions, `[N, K]` slabs, masked slots at position 0 and dt 0."""

    xyzs_cf: torch.Tensor  # [3, N, K] sample positions (clamped to +-bound)
    dirs_cf: torch.Tensor  # [3, N, K] ray directions (broadcast)
    dts: torch.Tensor  # [N, K] marching dt at each sample
    gaps: torch.Tensor  # [N, K] real t advance since the previous sample
    ts: torch.Tensor  # [N, K] sample t
    mask: torch.Tensor  # [N, K] bool validity
    counts: torch.Tensor  # [N] occupied rungs found (uncapped)
    next_t: torch.Tensor  # [N] resume t
    sel_idx: torch.Tensor  # [N, K] selected rung of each slot


def march_rays(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    t_start: torch.Tensor,  # [N]
    fars: torch.Tensor,  # [N]
    bitfield: torch.Tensor,
    *,
    bound: float,
    cascades: int,
    grid_size: int,
    dt_gamma: float = 0.0,
    max_steps: int = 1024,
    K: int = 128,
    noise: torch.Tensor | None = None,  # [N] in [0, 1): fraction of the first dt
) -> MarchResult:
    """Probe every ladder rung of every ray against the bitfield and keep
    each ray's first K occupied rungs before `fars` (`tngp/ops/march.py:
    236-355`, `group=0`): slot k holds the first rung whose running count of
    valid rungs reaches k + 1, found by a branch-free binary search over the
    counts; `next_t` is the (K+1)-th valid rung when the ray overflowed,
    else one rung past the ladder's end, capped at `fars`."""
    dev = rays_o.device
    N = rays_o.shape[0]
    S = max_steps
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascades - 1)) / grid_size

    o = rays_o.float()
    d = rays_d.float()
    t0 = t_start.float()
    if noise is not None:
        dt0 = torch.clamp(t0 * dt_gamma, dt_min, dt_max)
        t0 = t0 + dt0 * noise.float()
    fars = fars.float()

    ts = _t_ladder(t0, torch.arange(S, device=dev), dt_gamma, dt_min, dt_max)  # [N, S]
    dts = _dts(ts, dt_gamma, dt_min, dt_max)
    px = torch.clamp(o[:, 0:1] + ts * d[:, 0:1], -bound, bound)
    py = torch.clamp(o[:, 1:2] + ts * d[:, 1:2], -bound, bound)
    pz = torch.clamp(o[:, 2:3] + ts * d[:, 2:3], -bound, bound)
    mx = torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs()))
    lvl = mip_level_from_max(mx, dts, cascades, grid_size)
    cell = grid_cell_index_comp(px, py, pz, lvl, bound, cascades, grid_size)
    occ = bitfield_probe(bitfield, cell.reshape(-1)).reshape(N, S)
    valid = occ & (ts < fars[:, None])
    counts = valid.sum(dim=-1)

    # slot k <- the first rung s with rank[s] >= k + 1 (K + 1 slots: the
    # last is the resume point)
    rank = torch.cumsum(valid.long(), dim=-1)  # [N, S]
    kk = K + 1
    want = torch.arange(1, kk + 1, device=dev)[None, :]  # [1, K+1]
    lo = torch.zeros((N, kk), dtype=torch.int64, device=dev)
    hi = torch.full((N, kk), S, dtype=torch.int64, device=dev)
    for _ in range(max(1, S.bit_length())):
        mid = (lo + hi) >> 1
        r = torch.gather(rank, 1, torch.clamp(mid, max=S - 1))
        go_right = r < want
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    found = torch.clamp(lo, max=S - 1)  # [N, K+1]
    sel_idx = found[:, :K]
    maskf = (counts[:, None] >= want)[:, :K]

    packed = torch.stack([ts, dts, px, py, pz], dim=0)  # [5, N, S]
    sel = torch.gather(packed, 2, sel_idx[None].expand(5, N, K))  # [5, N, K]
    t_sel, dt_sel, xyz_sel = sel[0], sel[1], sel[2:]

    # gap = (t_i + dt_i) - (t_{i-1} + dt_{i-1}), with t_{-1} + dt_{-1} := t0
    t_post = t_sel + dt_sel
    prev = torch.cat([t0[:, None], t_post[:, :-1]], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gaps = torch.where(maskf, t_post - prev, zero)

    ladder_end = ts[:, -1] + dts[:, -1]
    resume_t = torch.gather(ts, 1, found[:, K:K + 1])[:, 0]
    next_t = torch.minimum(torch.where(counts > K, resume_t, ladder_end), fars)

    return MarchResult(
        xyzs_cf=torch.where(maskf[None], xyz_sel, zero),
        dirs_cf=d.T[:, :, None].expand(3, N, K),
        dts=torch.where(maskf, dt_sel, zero),
        gaps=gaps,
        ts=torch.where(maskf, t_sel, zero),
        mask=maskf,
        counts=counts,
        next_t=next_t,
        sel_idx=sel_idx,
    )
