"""The chunked ray march — `march_rays_chunked` of `tngp_torch/ops/march.py`
(the JAX package's `tngp/ops/march.py` `march_rays_chunked`) as a
hand-written CUDA kernel set, `march_chunked` in `tngp_torch/csrc/march.cu`.

It replaces no Pallas kernel: the JAX package writes this march in XLA, and
`march_rays_chunked_plain` below is its plain port, the body the CPU tests
hold exactly to the JAX march.  That form probes the G rungs of every slot
of the chunk budget however few chunks are live and finds each ray's
totals by branch-free binary searches: ~500 launches a call.  The kernels
walk each ray's own live chunks in three launches (coarse probe and cap,
count of the kept chunks' valid rungs, the write of the selection; the
scans over rays between them fused into the next launch), with no memset
and no host read.  Every output equals the plain version's on the card bit
for bit; `csrc/march.cu` says how and what bounds it.

`march_plan(N, NCr)` gives the launch from the shapes alone: `WARPS` warps a
block, a warp walking `rays a warp` consecutive rays, about `TARGET_BLOCKS`
blocks; `march.cu` sizes the warps' chunk lists from NCr.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.march import (
    ChunkedMarch,
    _binary_search,
    _dts,
    _ladder_consts,
    _noisy_start,
    _probe,
    _t_ladder,
    _to_index,
    build_dilated_cell_grid,
    chunk_dilate,
    nonzero_static,
)
from . import _lib

MARCH = _lib.register(
    "march_chunked", "march.cu", "none (XLA): tngp/ops/march.py:506", "tngp_march_chunked"
)

WARPS = 8  # warps a block (WARPS in march.cu)
TARGET_BLOCKS = 1056  # eight blocks an SM of the H100's 132
MAX_CHUNKS = 2048  # chunks a ray's ladder may hold (MAX_CHUNKS in march.cu)


@functools.lru_cache(maxsize=None)
def march_plan(N: int, NCr: int) -> tuple[int, int]:
    """(rays a warp, blocks) of the march kernels for N rays of NCr chunks:
    about TARGET_BLOCKS blocks of WARPS warps, each warp walking its rays in
    order.  Each later kernel sums every block's count, so the block count
    stays near the target however large N grows; a warp's chunk list (NCr
    int16 of shared memory) bounds NCr."""
    if N < 1:
        raise ValueError(f"the march kernels take at least one ray, got {N}")
    if not 1 <= NCr <= MAX_CHUNKS:
        raise ValueError(f"the march kernels take 1 to {MAX_CHUNKS} chunks a ray, got {NCr}")
    rpw = -(-N // (WARPS * TARGET_BLOCKS))
    return rpw, -(-N // (WARPS * rpw))


@functools.lru_cache(maxsize=64)
def _float_consts(max_steps: int, cascades: int, grid_size: int, bound: float,
                  dt_gamma: float, G: int) -> np.ndarray:
    """The march's float constants as torch's CUDA kernels round them: a
    Python scalar to f32, and a division by one as the product with its f32
    reciprocal (`march.cu`'s fconst)."""
    f32 = np.float32
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
    gamma = dt_gamma > 0.0
    lg = math.log(1.0 + dt_gamma) if gamma else 1.0
    dilate = chunk_dilate(G, max_steps, grid_size, bound)
    return np.array([
        dt_min, dt_max, dt_gamma,
        dt_min / dt_gamma if gamma else 0.0, dt_max / dt_gamma if gamma else 0.0, lg,
        f32(1.0) / f32(dt_min), f32(1.0) / f32(lg),
        bound, f32(1.0) / f32(2.0 * bound), dilate * (2.0 * bound / grid_size) + 1e-6,
    ], dtype=np.float32)


def march_rays_chunked_cuda(rays_o, rays_d, t_start, fars, bitfield, *, bound, cascades,
                            grid_size, dt_gamma, max_steps, M_budget, G, chunk_budget, noise,
                            dilated_grid, ladder_steps, ray_chunk_cap) -> ChunkedMarch:
    """`march_rays_chunked` through the march kernels: one launch of three
    kernels, outputs in one allocation.  Same arguments and result as
    `march_rays_chunked_plain`; CUDA tensors, rays_o / rays_d [N, 3] any
    strides."""
    N = rays_o.shape[0]
    S = max_steps
    S_lad = S if ladder_steps is None else min(ladder_steps, S)
    if S % G or S_lad % G:
        raise ValueError(f"max_steps {S} / ladder_steps {S_lad} must be "
                         f"multiples of chunk size {G}")
    NCr = S_lad // G
    if N * S > 2**31 - 1:
        raise ValueError(f"the march kernels index N * max_steps = {N * S} rungs in int32")
    if M_budget < 1:
        raise ValueError(f"M_budget {M_budget} is not positive")
    rpw, blocks = march_plan(N, NCr)
    if dilated_grid is None:
        dilated_grid = build_dilated_cell_grid(
            bitfield, bound=bound, cascades=cascades, grid_size=grid_size,
            dilate=chunk_dilate(G, max_steps, grid_size, bound))
    if chunk_budget is None:
        chunk_budget = -(-3 * M_budget // G)
    CB = min(N * NCr, -(-chunk_budget // 128) * 128)
    o, d = rays_o.float(), rays_d.float()  # any strides
    if not (o.is_cuda and d.is_cuda and o.shape == d.shape == (N, 3)):
        raise ValueError(f"rays_o, rays_d: expected CUDA tensors of shape ({N}, 3)")
    t_start, fars = t_start.float().contiguous(), fars.float().contiguous()
    checks = [(t_start, "t_start", torch.float32, (N,)), (fars, "fars", torch.float32, (N,)),
              (dilated_grid, "dilated_grid", torch.bool, (grid_size**3,)),
              (bitfield, "bitfield", torch.uint8, (cascades * grid_size**3 // 8,))]
    if noise is not None:
        noise = noise.float().contiguous()
        checks.append((noise, "noise", torch.float32, (N,)))
    for args in checks:
        _lib.check(*args)
    W = -(-NCr // 32)
    # one int64 buffer: sel [M], m_eff and num_points, then 32-bit words (t0,
    # resume_t, the scratch of march.cu), then bytes (sel_valid, ray_mask)
    n32 = N * (W + 6) + 3 * blocks
    h32 = -(-n32 // 2)
    buf = torch.empty((M_budget + 2 + h32 + -(-(M_budget + N) // 8),), dtype=torch.int64,
                      device=o.device)
    words = buf[M_budget + 2:M_budget + 2 + h32].view(torch.int32)
    t0, resume_t = words[:N].view(torch.float32), words[N:2 * N].view(torch.float32)
    flags8 = buf[M_budget + 2 + h32:].view(torch.uint8)
    sel_valid, ray_mask = flags8[:M_budget].view(torch.bool), flags8[M_budget:M_budget + N].view(
        torch.bool)
    iconst = np.array([N, S, S_lad, G, NCr, grid_size, cascades,
                       -1 if ray_chunk_cap is None else ray_chunk_cap, CB, M_budget, rpw,
                       blocks, int(dt_gamma > 0.0), *o.stride(), *d.stride()], dtype=np.int64)
    fconst = _float_consts(max_steps, cascades, grid_size, float(bound), float(dt_gamma), G)
    _lib.launch(
        MARCH, o.device,
        o.data_ptr(), d.data_ptr(), t_start.data_ptr(), fars.data_ptr(),
        None if noise is None else noise.data_ptr(), bitfield.data_ptr(),
        dilated_grid.data_ptr(), iconst.ctypes.data, fconst.ctypes.data,
        words[2 * N:].data_ptr(), buf.data_ptr(), sel_valid.data_ptr(),
        buf[M_budget:].data_ptr(), ray_mask.data_ptr(), t0.data_ptr(), resume_t.data_ptr(),
    )
    return ChunkedMarch(sel=buf[:M_budget], sel_valid=sel_valid, m_eff=buf[M_budget],
                        ray_mask=ray_mask, num_points=buf[M_budget + 1], t0=t0,
                        resume_t=resume_t)


def march_rays_chunked_plain(
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
    """Plain version of the march kernels: the JAX march op by op (see the
    JAX docstring at tngp/ops/march.py:526-546 for the exact-prefix
    contract, the ladder window `ladder_steps` and the per-ray live-chunk
    cap `ray_chunk_cap`)."""
    dev = rays_o.device
    N = rays_o.shape[0]
    S = max_steps
    S_lad = S if ladder_steps is None else min(ladder_steps, S)
    if S % G or S_lad % G:
        raise ValueError(f"max_steps {S} / ladder_steps {S_lad} must be "
                         f"multiples of chunk size {G}")
    NCr = S_lad // G
    dt_min, dt_max = _ladder_consts(max_steps, cascades, grid_size)
    cell = 2.0 * bound / grid_size
    dilate = chunk_dilate(G, max_steps, grid_size, bound)

    o = rays_o.float()
    d = rays_d.float()
    t0 = _noisy_start(t_start, noise, dt_gamma, dt_min, dt_max)
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
    occ = _probe(o[cray], d[cray], ts, bitfield, bound=bound, cascades=cascades,
                 grid_size=grid_size, dt_gamma=dt_gamma, dt_min=dt_min, dt_max=dt_max)[4]
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
