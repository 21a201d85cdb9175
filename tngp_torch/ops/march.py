"""Occupancy-grid ray marching with static shapes — the port of
`tngp/ops/march.py`: the chunked march (`march_rays_chunked`,
`ladder_samples`), the slab march `march_rays` (flat, and grouped with
`group > 0`), the dense march `march_rays_dense`, the stream march
`march_rays_stream`, and the helpers they use (`mip_level`,
`grid_cell_index`, `build_coarse_occupancy`, `build_dilated_cell_grid`,
`_first_k_ranks`).

The ladder: every ray visits the same deterministic rungs

    t_{j+1} = t_j + clamp(t_j * dt_gamma, dt_min, dt_max)

whose closed form (`_t_ladder`) is evaluated for all rungs in parallel.  The
chunked march probes G-rung chunk midpoints against a dilated occupancy
grid, fine-probes only the candidate chunks and emits the first `M_budget`
valid samples in flat (ray-major) order.  The grouped slab march probes
g-rung group midpoints against a dilated coarse grid and fine-probes the
first K/g live groups of each ray.  For the same inputs the integer outputs
(`sel`, `sel_valid`, `m_eff`, `ray_mask`, `num_points`; the slab marches'
`mask`, `counts` and selected rungs; the stream march's `mask` and
`counts`) equal the JAX package's exactly; the float arithmetic follows the
JAX expressions operation by operation so that the occupancy probes agree
bit for bit.

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


def mip_level(xyz: torch.Tensor, dt: torch.Tensor, cascades: int,
              grid_size: int) -> torch.Tensor:
    """Batch-first wrapper of `mip_level_from_max` (xyz `[..., 3]`)."""
    return mip_level_from_max(xyz.abs().amax(dim=-1), dt, cascades, grid_size)


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


def grid_cell_index(xyz: torch.Tensor, level: torch.Tensor, bound: float, cascades: int,
                    grid_size: int) -> torch.Tensor:
    """Batch-first wrapper of `grid_cell_index_comp` (xyz `[..., 3]`)."""
    return grid_cell_index_comp(xyz[..., 0], xyz[..., 1], xyz[..., 2], level, bound,
                                cascades, grid_size)


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


def _cascade_union(cells: torch.Tensor, *, bound: float, cascades: int) -> torch.Tensor:
    """[cascades, h, h, h] 0/1 occupancy -> [h, h, h] float counts over the
    global cube [-bound, bound]: each cascade's cells added onto the global
    cells they overlap.  The counts are small integers, summed in float64
    (exact, and out of TF32's reach), then returned as float32."""
    h = cells.shape[-1]
    g = torch.zeros((h, h, h), dtype=torch.float64, device=cells.device)
    for cas in range(cascades):
        b_c = min(2.0**cas, bound)
        if b_c >= bound:
            g = g + cells[cas].double()
        else:
            M = torch.as_tensor(_coarse_cascade_map(b_c, bound, h), dtype=torch.float64,
                                device=g.device)
            g = g + torch.einsum("ijk,ia,jb,kc->abc", cells[cas].double(), M, M, M)
    return g.float()


def build_coarse_occupancy(bitfield: torch.Tensor, *, bound: float, cascades: int,
                           grid_size: int, halfext: float, hc: int = 16) -> torch.Tensor:
    """Cascade-union dilated coarse occupancy for the grouped march: each
    cascade's [H^3] bits max-pooled to [hc^3] (hc = min(hc, H)), mapped onto
    the global coarse grid over [-bound, bound], and max-pool dilated by
    ceil(halfext / coarse cell) cells, so that the cell of a group's
    t-midpoint is conservative for every rung within +-halfext of it.
    Returns flat [hc^3] bool, linear cell order."""
    H = grid_size
    hc = min(hc, H)
    if H % hc:
        raise ValueError(f"grid_size {H} must be a multiple of coarse size {hc}")
    r = H // hc
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    bits = (bitfield.to(torch.int32)[:, None] >> shifts) & 1
    pooled = bits.reshape(cascades, hc, r, hc, r, hc, r).amax(dim=(2, 4, 6))
    coarse = _cascade_union(pooled, bound=bound, cascades=cascades)
    dil = max(1, int(math.ceil(halfext / (2.0 * bound / hc))))
    # reduce_window SAME with -inf padding: a max pool padded by dil
    coarse = F.max_pool3d(coarse[None, None], kernel_size=2 * dil + 1, stride=1, padding=dil)
    return (coarse[0, 0] > 0.5).reshape(-1)


def build_dilated_cell_grid(bitfield: torch.Tensor, *, bound: float,
                            cascades: int, grid_size: int,
                            dilate: int) -> torch.Tensor:
    """Cascade-union occupancy at full resolution, max-pool dilated by
    `dilate` cells per axis.  Returns flat [H^3] bool over [-bound, bound]."""
    H = grid_size
    shifts = torch.arange(8, dtype=torch.int32, device=bitfield.device)
    bits = (bitfield.to(torch.int32)[:, None] >> shifts) & 1
    g = _cascade_union(bits.reshape(cascades, H, H, H), bound=bound, cascades=cascades)
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


def _ladder_consts(max_steps: int, cascades: int, grid_size: int):
    """(dt_min, dt_max) of the ladder."""
    return 2.0 * SQRT3 / max_steps, 2.0 * SQRT3 * (2 ** (cascades - 1)) / grid_size


def _noisy_start(t_start, noise, dt_gamma, dt_min, dt_max):
    """The ladder origin: t_start shifted by `noise` (in [0, 1)) of its dt."""
    t0 = t_start.float()
    if noise is not None:
        t0 = t0 + torch.clamp(t0 * dt_gamma, dt_min, dt_max) * noise.float()
    return t0


def _probe(o, d, ts, bitfield, *, bound, cascades, grid_size, dt_gamma, dt_min, dt_max):
    """Positions, dts and occupancy of the rungs at `ts` ([N, R]): (px, py,
    pz, dts, occ), each [N, R]."""
    dts = _dts(ts, dt_gamma, dt_min, dt_max)
    px = torch.clamp(o[:, 0:1] + ts * d[:, 0:1], -bound, bound)
    py = torch.clamp(o[:, 1:2] + ts * d[:, 1:2], -bound, bound)
    pz = torch.clamp(o[:, 2:3] + ts * d[:, 2:3], -bound, bound)
    mx = torch.maximum(px.abs(), torch.maximum(py.abs(), pz.abs()))
    lvl = mip_level_from_max(mx, dts, cascades, grid_size)
    cell = grid_cell_index_comp(px, py, pz, lvl, bound, cascades, grid_size)
    occ = bitfield_probe(bitfield, cell.reshape(-1)).reshape(ts.shape)
    return px, py, pz, dts, occ


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
    window `ladder_steps` and the per-ray live-chunk cap `ray_chunk_cap`).
    A CPU tensor, or a call inside `plain_versions()`, takes the plain
    version `march_rays_chunked_plain`; a CUDA tensor launches the march
    kernels (`tngp_torch/kernels/march.py`), which give the same outputs."""
    from ..kernels import _lib, march  # the kernels' module imports this one

    run = march.march_rays_chunked_plain if _lib.use_plain(rays_o) else (
        march.march_rays_chunked_cuda)
    return run(rays_o, rays_d, t_start, fars, bitfield, bound=bound, cascades=cascades,
               grid_size=grid_size, dt_gamma=dt_gamma, max_steps=max_steps,
               M_budget=M_budget, G=G, chunk_budget=chunk_budget, noise=noise,
               dilated_grid=dilated_grid, ladder_steps=ladder_steps,
               ray_chunk_cap=ray_chunk_cap)


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
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
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
    """Result of the slab marches `march_rays` and `march_rays_dense`:
    channels-first positions and directions, `[N, K]` slabs (`[N, S]` for
    the dense march), masked slots at position 0 and dt 0."""

    xyzs_cf: torch.Tensor  # [3, N, K] sample positions (clamped to +-bound)
    dirs_cf: torch.Tensor  # [3, N, K] ray directions (broadcast)
    dts: torch.Tensor  # [N, K] marching dt at each sample
    gaps: torch.Tensor  # [N, K] real t advance since the previous valid sample
    ts: torch.Tensor  # [N, K] sample t
    mask: torch.Tensor  # [N, K] bool validity
    counts: torch.Tensor  # [N] occupied rungs found (uncapped by K on the flat path)
    next_t: torch.Tensor  # [N] resume t
    sel_idx: torch.Tensor  # [N, K] rung of each slot


def _interleaved_gaps(ts, dts, mask, t0):
    """gap = advance since the previous VALID rung (invalid rungs between):
    a cummax over the valid rungs' t + dt, from t0."""
    t_post = ts + dts
    neg_inf = torch.full_like(t_post, -math.inf)
    run = torch.cummax(torch.where(mask, t_post, neg_inf), dim=1).values
    prev = torch.maximum(torch.cat([t0[:, None], run[:, :-1]], dim=1), t0[:, None])
    return torch.where(mask, t_post - prev, torch.zeros((), device=ts.device))


def _first_k_ranks(valid: torch.Tensor, kk: int):
    """Branch-free binary search: slot k holds the first column s with
    cumsum(valid)[s] >= k + 1.  valid [N, S] bool -> (found [N, kk] clamped
    to S - 1, counts [N])."""
    N, S = valid.shape
    rank = torch.cumsum(valid.long(), dim=-1)  # [N, S]
    want = torch.arange(1, kk + 1, device=valid.device)[None, :]
    lo = torch.zeros((N, kk), dtype=torch.int64, device=valid.device)
    hi = torch.full((N, kk), S, dtype=torch.int64, device=valid.device)
    for _ in range(max(1, S.bit_length())):
        mid = (lo + hi) >> 1
        r = torch.gather(rank, 1, torch.clamp(mid, max=S - 1))
        go_right = r < want
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return torch.clamp(lo, max=S - 1), rank[:, -1]


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
    group: int = 0,  # > 0: the grouped march (`_march_rays_grouped`)
) -> MarchResult:
    """The slab march (`tngp/ops/march.py:236-352`).  With `group = 0`:
    probe every ladder rung of every ray against the bitfield and keep each
    ray's first K occupied rungs before `fars`: slot k holds the first rung
    whose running count of valid rungs reaches k + 1; `next_t` is the
    (K+1)-th valid rung when the ray overflowed, else one rung past the
    ladder's end, capped at `fars`.  The noise shifts the origin before the
    group dispatch, as in the JAX function."""
    dev = rays_o.device
    N = rays_o.shape[0]
    S = max_steps
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
    o = rays_o.float()
    d = rays_d.float()
    t0 = _noisy_start(t_start, noise, dt_gamma, dt_min, dt_max)
    fars = fars.float()
    geo = dict(bound=bound, cascades=cascades, grid_size=grid_size, dt_gamma=dt_gamma,
               dt_min=dt_min, dt_max=dt_max)
    if group > 0:
        return _march_rays_grouped(o, d, t0, fars, bitfield, max_steps=max_steps, K=K,
                                   group=group, **geo)

    ts = _t_ladder(t0, torch.arange(S, device=dev), dt_gamma, dt_min, dt_max)  # [N, S]
    px, py, pz, dts, occ = _probe(o, d, ts, bitfield, **geo)
    valid = occ & (ts < fars[:, None])
    # K + 1 slots: the last is the resume point
    found, counts = _first_k_ranks(valid, K + 1)
    sel_idx = found[:, :K]
    maskf = counts[:, None] >= torch.arange(1, K + 1, device=dev)[None, :]

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


def _group_live(o, d, t0, fars, coarse, *, bound, hc, group, max_steps, dt_gamma, dt_min,
                dt_max) -> torch.Tensor:
    """The grouped march's coarse stage: one probe of the dilated coarse grid
    at each `group`-rung group's t-midpoint, floor((p + bound) / (2 bound)
    hc) per axis.  Returns live [N, max_steps / group] bool."""
    g = group
    jg = torch.arange(max_steps // g, device=o.device) * g
    t_lo = _t_ladder(t0, jg, dt_gamma, dt_min, dt_max)  # [N, S/g]
    t_hi = _t_ladder(t0, jg + (g - 1), dt_gamma, dt_min, dt_max)
    tc = 0.5 * (t_lo + t_hi)
    cix = []
    for c in range(3):
        p = torch.clamp(o[:, c:c + 1] + tc * d[:, c:c + 1], -bound, bound)
        cix.append(_to_index(torch.floor((p + bound) / (2.0 * bound) * hc), hc))
    ccell = (cix[0] * hc + cix[1]) * hc + cix[2]
    return coarse[ccell.reshape(-1)].reshape(tc.shape) & (t_lo < fars[:, None])


def _march_rays_grouped(o, d, t0, fars, bitfield, *, bound, cascades, grid_size, dt_gamma,
                        dt_min, dt_max, max_steps, K, group) -> MarchResult:
    """The two-level slab march (`tngp/ops/march.py:878-987`): probe the
    ladder in groups of `group` rungs at each group's t-midpoint against a
    dilated coarse occupancy grid (hc = min(32, H)), then fine-probe only
    the first K / group live groups of each ray.  Under overflow it keeps
    every rung of those groups (some probe empty), where the flat march
    keeps the first K occupied rungs; both resume exactly at `next_t` (the
    (K/group + 1)-th live group's first rung), so iterated marches emit
    every occupied rung once."""
    dev = o.device
    N = o.shape[0]
    S = max_steps
    g = group
    if S % g or K % g:
        raise ValueError(f"max_steps {S} and K {K} must be multiples of group {g}")
    Gk = K // g
    # a group's t-span: with dt_gamma = 0 every rung advances dt_min
    halfext = 0.5 * g * (dt_min if dt_gamma <= 0 else dt_max)
    hc = min(32, grid_size)
    coarse = build_coarse_occupancy(bitfield, bound=bound, cascades=cascades,
                                    grid_size=grid_size, halfext=halfext, hc=hc)

    live = _group_live(o, d, t0, fars, coarse, bound=bound, hc=hc, group=g, max_steps=S,
                       dt_gamma=dt_gamma, dt_min=dt_min, dt_max=dt_max)

    # ---- the first Gk live groups (+1 for the resume point) ---------------
    found, live_counts = _first_k_ranks(live, Gk + 1)
    grp_valid = live_counts[:, None] >= torch.arange(1, Gk + 1, device=dev)[None, :]

    # ---- fine stage: ladder + occupancy probe on the selected rungs only --
    jsel = (found[:, :Gk, None] * g + torch.arange(g, device=dev)).reshape(N, K)
    ts = _t_ladder(t0, jsel, dt_gamma, dt_min, dt_max)  # [N, K]
    px, py, pz, dts, occ = _probe(o, d, ts, bitfield, bound=bound, cascades=cascades,
                                  grid_size=grid_size, dt_gamma=dt_gamma, dt_min=dt_min,
                                  dt_max=dt_max)
    maskf = occ & (ts < fars[:, None]) & grp_valid.repeat_interleave(g, dim=1)
    gaps = _interleaved_gaps(ts, dts, maskf, t0)

    # resume at the (Gk+1)-th live group's first rung; else past the ladder
    t_last = _t_ladder(t0, torch.full((1,), S - 1, device=dev), dt_gamma, dt_min, dt_max)[:, 0]
    ladder_end = t_last + _dts(t_last, dt_gamma, dt_min, dt_max)
    resume_t = _t_ladder(t0, (found[:, Gk] * g)[:, None], dt_gamma, dt_min, dt_max)[:, 0]
    next_t = torch.minimum(torch.where(live_counts > Gk, resume_t, ladder_end), fars)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return MarchResult(
        xyzs_cf=torch.where(maskf[None], torch.stack([px, py, pz]), zero),
        dirs_cf=d.T[:, :, None].expand(3, N, K),
        dts=torch.where(maskf, dts, zero),
        gaps=gaps,
        ts=torch.where(maskf, ts, zero),
        mask=maskf,
        counts=maskf.sum(dim=-1),
        next_t=next_t,
        sel_idx=jsel,
    )


def march_rays_dense(
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
    noise: torch.Tensor | None = None,
) -> MarchResult:
    """The slab-free march (`tngp/ops/march.py:361-436`): every ladder rung
    of every ray, the full `[N, S]` rung arrays with a validity mask, the
    gaps over the interleaved invalid rungs by a cummax, and `next_t` at the
    ladder's end (capped at `fars`)."""
    dev = rays_o.device
    N = rays_o.shape[0]
    S = max_steps
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
    o = rays_o.float()
    d = rays_d.float()
    t0 = _noisy_start(t_start, noise, dt_gamma, dt_min, dt_max)
    fars = fars.float()
    ts = _t_ladder(t0, torch.arange(S, device=dev), dt_gamma, dt_min, dt_max)  # [N, S]
    px, py, pz, dts, occ = _probe(o, d, ts, bitfield, bound=bound, cascades=cascades,
                                  grid_size=grid_size, dt_gamma=dt_gamma, dt_min=dt_min,
                                  dt_max=dt_max)
    maskf = occ & (ts < fars[:, None])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return MarchResult(
        xyzs_cf=torch.where(maskf[None], torch.stack([px, py, pz]), zero),
        dirs_cf=d.T[:, :, None].expand(3, N, S),
        dts=torch.where(maskf, dts, zero),
        gaps=_interleaved_gaps(ts, dts, maskf, t0),
        ts=torch.where(maskf, ts, zero),
        mask=maskf,
        counts=maskf.sum(dim=-1),
        next_t=torch.minimum(ts[:, -1] + dts[:, -1], fars),
        sel_idx=torch.arange(S, device=dev).expand(N, S),
    )


class StreamMarch(NamedTuple):
    """Result of `march_rays_stream`: the rung verdicts only; the compacted
    samples' geometry comes from `ladder_samples`."""

    mask: torch.Tensor  # [N, S] bool rung validity
    counts: torch.Tensor  # [N] valid rungs per ray
    t0: torch.Tensor  # [N] noise-shifted ladder origin
    next_t: torch.Tensor  # [N] ladder end, capped at fars


def march_rays_stream(
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
    noise: torch.Tensor | None = None,
) -> StreamMarch:
    """`march_rays_dense` without the `[*, N, S]` arrays
    (`tngp/ops/march.py:774-831`): the same rung, position, mip-level and
    probe arithmetic, returning only the mask, the counts, the ladder
    origin and the ladder's end."""
    dev = rays_o.device
    S = max_steps
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
    t0 = _noisy_start(t_start, noise, dt_gamma, dt_min, dt_max)
    fars = fars.float()
    ts = _t_ladder(t0, torch.arange(S, device=dev), dt_gamma, dt_min, dt_max)  # [N, S]
    _, _, _, dts, occ = _probe(rays_o.float(), rays_d.float(), ts, bitfield, bound=bound,
                               cascades=cascades, grid_size=grid_size, dt_gamma=dt_gamma,
                               dt_min=dt_min, dt_max=dt_max)
    maskf = occ & (ts < fars[:, None])
    return StreamMarch(mask=maskf, counts=maskf.sum(dim=-1), t0=t0,
                       next_t=torch.minimum(ts[:, -1] + dts[:, -1], fars))
