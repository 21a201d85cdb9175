"""The march kernels' host side on the CPU (`tngp_torch/kernels/march.py`):
the launch plan, the dispatch (CPU tensors and `plain_versions()` take
`march_rays_chunked_plain` and launch nothing), the registry entry, and a
mirror of the kernels' three passes (`csrc/march.cu`) held exactly to the
plain version.  `tests/test_torch_march_kernel_gpu.py` holds the kernels
themselves to the plain version on a card.  No JAX."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tngp_torch.kernels import _lib, plain_versions
from tngp_torch.kernels import march as km
from tngp_torch.ops import march as tm
from tngp_torch.ops.grid_utils import packbits
from tngp_torch.ops.rays import near_far_from_aabb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
H = 32


def small_inputs(seed: int, N: int = 96, cascades: int = 1, bound: float = 1.0,
                 occupied: float = 0.02):
    """Rays from z = -2.5 toward the box (ray 0 misses it: near = far =
    3.4e38) and a bitfield of a ball and scattered cells (cascade c the
    ball's scale 2^-c), as `tests/test_torch_march.py` makes them, in torch."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -2.5 * bound]) + rng.normal(0, 0.05, size=(N, 3))
    d = rng.uniform(-0.6, 0.6, size=(N, 3)) * bound - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [1.0, 0.0, 0.0]
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    occ = [((gx**2 + gy**2 + gz**2) < (0.55 * 2.0**c) ** 2)
           | (rng.uniform(size=gx.shape) < occupied) for c in range(cascades)]
    bits = packbits(torch.from_numpy(np.concatenate([g.reshape(-1) for g in occ])
                                     .astype(np.float32)), 0.5)
    nears, fars = near_far_from_aabb(o, d, (-bound,) * 3 + (bound,) * 3, 0.05)
    return o, d, nears, fars, bits


def mirror(o, d, t_start, fars, bitfield, *, bound, cascades, grid_size, dt_gamma=0.0,
           max_steps=1024, M_budget, G=8, chunk_budget=None, noise=None, dilated_grid=None,
           ladder_steps=None, ray_chunk_cap=None):
    """The three passes of `csrc/march.cu`, a ray at a time in numpy, on
    the plain version's own probes of every chunk and rung: (1) each ray's
    live chunks up to the cap, the cut chunk's t_lo, the first live chunk;
    (2) the global rank R of a ray's first live chunk, its kept chunks
    K = clamp(CB - R, 0, L), their valid rungs V, the chunk-budget flag;
    (3) each ray's sample base, its first `taken` valid rungs into sel, its
    resume t and ray_mask, the padded tail."""
    N, S = o.shape[0], max_steps
    S_lad = S if ladder_steps is None else min(ladder_steps, S)
    NCr = S_lad // G
    dt_min, dt_max = tm._ladder_consts(max_steps, cascades, grid_size)
    t0 = tm._noisy_start(t_start, noise, dt_gamma, dt_min, dt_max)
    grid = dilated_grid if dilated_grid is not None else tm.build_dilated_cell_grid(
        bitfield, bound=bound, cascades=cascades, grid_size=grid_size,
        dilate=tm.chunk_dilate(G, S, grid_size, bound))
    jg = torch.arange(NCr) * G
    t_lo = tm._t_ladder(t0, jg, dt_gamma, dt_min, dt_max)
    t_hi = tm._t_ladder(t0, jg + (G - 1), dt_gamma, dt_min, dt_max)
    tc = 0.5 * (t_lo + t_hi)
    cix = [tm._to_index(torch.floor((torch.clamp(o[:, c:c + 1] + tc * d[:, c:c + 1], -bound,
                                                 bound) + bound) / (2.0 * bound) * grid_size),
                        grid_size) for c in range(3)]
    live = grid[((cix[0] * grid_size + cix[1]) * grid_size + cix[2]).reshape(-1)].reshape(N, NCr)
    dilate = tm.chunk_dilate(G, S, grid_size, bound)
    live = ((live | (0.5 * (t_hi - t_lo) > dilate * 2.0 * bound / grid_size + 1e-6))
            & (t_lo < fars[:, None])).numpy()
    ts = tm._t_ladder(t0, torch.arange(S_lad), dt_gamma, dt_min, dt_max)
    occ = tm._probe(o, d, ts, bitfield, bound=bound, cascades=cascades, grid_size=grid_size,
                    dt_gamma=dt_gamma, dt_min=dt_min, dt_max=dt_max)[4]
    valid = (occ & (ts < fars[:, None])).numpy()
    t_lo = t_lo.numpy()
    cap = -1 if ray_chunk_cap is None else ray_chunk_cap

    # 1. the coarse pass
    chunks, cut, tcut = [], np.zeros(N, bool), np.zeros(N, np.float32)
    for n in range(N):
        kept = []
        for c in np.flatnonzero(live[n]):
            if len(kept) == cap:
                cut[n], tcut[n] = True, t_lo[n, c]
                break
            kept.append(c)
        chunks.append(kept)
    L = np.array([len(k) for k in chunks])
    first = next((n * NCr + k[0] for n, k in enumerate(chunks) if k), None)

    # 2. the count pass
    if chunk_budget is None:
        chunk_budget = -(-3 * M_budget // G)
    CB = min(N * NCr, -(-chunk_budget // 128) * 128)
    R = np.concatenate([[0], np.cumsum(L)[:-1]])
    rungs = [[c * G + g for c in chunks[n][:max(0, min(L[n], CB - R[n]))] for g in range(G)
              if valid[n, c * G + g]] for n in range(N)]
    V = np.array([len(r) for r in rungs])
    g_cut = (R + L >= CB) & (L.sum() > CB)

    # 3. the write pass
    m_eff = min(int(V.sum()), M_budget)
    base = np.concatenate([[0], np.cumsum(V)[:-1]])
    taken = np.minimum(V, np.maximum(m_eff - base, 0))
    fill = (N - 1) * S + (NCr - 1) * G if first is None else (
        first // NCr * S + first % NCr * G)
    sel = np.full(M_budget, fill, np.int64)
    last = np.zeros(N, np.int64)
    for n in range(N):
        sel[base[n]:base[n] + taken[n]] = n * S + np.array(rungs[n][:taken[n]], np.int64)
        last[n] = rungs[n][taken[n] - 1] if taken[n] else 0
    t_sel = tm._t_ladder(t0, torch.from_numpy(last)[:, None], dt_gamma, dt_min, dt_max)[:, 0]
    t_after = torch.where(torch.from_numpy(taken > 0),
                          t_sel + tm._dts(t_sel, dt_gamma, dt_min, dt_max), t0)
    t_last = tm._t_ladder(t0, torch.full((N, 1), S_lad - 1), dt_gamma, dt_min, dt_max)[:, 0]
    t_end = t_last + tm._dts(t_last, dt_gamma, dt_min, dt_max)
    trunc = torch.from_numpy(cut | g_cut)
    resume = torch.minimum(torch.where(torch.from_numpy(taken < V) | trunc, t_after, t_end),
                           fars)
    no_take = torch.from_numpy(cut & (V == 0) & ~g_cut)
    resume = torch.where(no_take, torch.minimum(torch.from_numpy(tcut), fars), resume)
    return tm.ChunkedMarch(
        sel=torch.from_numpy(sel), sel_valid=torch.arange(M_budget) < m_eff,
        m_eff=torch.tensor(m_eff), ray_mask=torch.from_numpy(base + V <= m_eff) & ~trunc,
        num_points=torch.tensor(int(V.sum())), t0=t0, resume_t=resume)


def assert_same(a, b):
    """Every output equal, the floats bit for bit."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y.to(x.dtype)), name


# the cases of tests/test_torch_march_chunked.py and the edge cases the
# kernels' walk has to get right: (inputs kw, march kw)
CASES = [
    ({}, dict(M_budget=4096)),
    ({}, dict(M_budget=1024, ray_chunk_cap=8, chunk_budget=2048)),
    ({}, dict(M_budget=640, ladder_steps=128, noise=True)),
    ({}, dict(M_budget=512, ladder_steps=64, ray_chunk_cap=2, chunk_budget=256)),
    (dict(cascades=2, bound=2.0), dict(M_budget=2048, dt_gamma=1.0 / 128, noise=True,
                                       ray_chunk_cap=4)),
    (dict(N=200), dict(M_budget=1536, chunk_budget=128)),  # n_live above CB
    (dict(occupied=0.0), dict(M_budget=256, ray_chunk_cap=0)),  # no chunk kept at all
    ({}, dict(M_budget=384, at_far=True)),  # every ray starts at its far
]


def case_inputs(ikw, mkw, seed):
    cascades, bound = ikw.get("cascades", 1), ikw.get("bound", 1.0)
    o, d, nears, fars, bits = small_inputs(seed, ikw.get("N", 96), cascades, bound,
                                           ikw.get("occupied", 0.02))
    if ikw.get("occupied") == 0.0:
        bits = torch.zeros_like(bits)
    mkw = dict(mkw)
    if mkw.pop("at_far", False):
        nears = fars.clone()
    if mkw.pop("noise", False):
        mkw["noise"] = torch.from_numpy(
            np.random.default_rng(seed + 1).uniform(size=o.shape[0]).astype(np.float32))
    return (o, d, nears, fars, bits), dict(bound=bound, cascades=cascades, grid_size=H,
                                           max_steps=256, G=8, **mkw)


def test_march_plan():
    """About TARGET_BLOCKS blocks of WARPS warps cover the rays, each warp
    walking consecutive ones; the longest chunk lists fit a block's shared
    memory without opting in to more than 48 KB; the bounds raise."""
    for N, NCr in [(65_536, 64), (65_536, 16), (16_384, 128), (4096, 16), (96, 32), (1, 1),
                   (1_048_576, 128), (655_360, 2048)]:
        rpw, blocks = km.march_plan(N, NCr)
        assert blocks * km.WARPS * rpw >= N > (blocks - 1) * km.WARPS * rpw
        assert blocks <= km.TARGET_BLOCKS and (N < km.WARPS * km.TARGET_BLOCKS or blocks > 512)
    assert km.WARPS * km.MAX_CHUNKS * 2 <= 48 * 1024
    assert km.march_plan(65_536, 64) == (8, 1024)
    assert km.march_plan(16_384, 128) == (2, 1024)
    for N, NCr in [(0, 16), (16, 0), (16, km.MAX_CHUNKS + 1)]:
        with pytest.raises(ValueError):
            km.march_plan(N, NCr)


def test_cpu_and_plain_versions_take_the_plain_march(monkeypatch):
    """CPU tensors, outside and inside `plain_versions()`, run the plain
    version and launch nothing; `plain_versions()` sends a CUDA device to
    the plain version too, where outside it the kernels must launch."""
    def boom(*a, **k):
        raise AssertionError("the march kernels reached with a CPU tensor")

    args, kw = case_inputs(*CASES[1], seed=4)
    want = km.march_rays_chunked_plain(*args, **kw)
    monkeypatch.setattr(km, "march_rays_chunked_cuda", boom)
    _lib.reset_launch_counts()
    assert_same(tm.march_rays_chunked(*args, **kw), want)
    with plain_versions():
        assert_same(tm.march_rays_chunked(*args, **kw), want)
    assert km.MARCH.launches == 0

    class OnCard:  # what `use_plain` reads of a tensor
        device = torch.device("cuda", 0)

    assert not _lib.use_plain(OnCard())
    with plain_versions():
        assert _lib.use_plain(OnCard())


def test_march_kernel_is_registered():
    """The registry entry: its source, the exported launcher and its C
    signature, and that it replaces no Pallas kernel but names the JAX
    package's XLA march."""
    info = _lib.KERNELS["march_chunked"]
    assert info is km.MARCH and info.source == "tngp_torch/csrc/march.cu"
    src = (ROOT / info.source).read_text()
    assert re.search(r'extern "C" int tngp_march_chunked\(', src)
    assert [s[0] for s in _lib._SIGNATURES["march.cu"]] == [info.symbol]
    assert info.replaces.startswith("none (XLA): ")
    path, line = info.replaces.split(": ")[1].split(":")
    assert (ROOT / path).read_text().splitlines()[int(line) - 1] == "def march_rays_chunked("
    assert "pallas_call" not in src and "WARPS 8" in src and f"MAX_CHUNKS {km.MAX_CHUNKS}" in src


def test_kernel_passes_mirror_the_plain_march():
    """The kernels' decomposition — per-ray live counts and the cap, the
    scans over rays, the kept chunks of the chunk budget, the sample bases,
    the last taken rung, the padded tail — gives the plain version's
    outputs exactly, on the four cases of `test_torch_march_chunked.py`,
    dt_gamma 1/128 on two cascades, n_live above the chunk budget, no live
    chunk and every ray at its far."""
    for i, (ikw, mkw) in enumerate(CASES):
        args, kw = case_inputs(ikw, mkw, seed=5 + i)
        want = km.march_rays_chunked_plain(*args, **kw)
        assert_same(mirror(*args, **kw), want)
        if i == 5:
            assert int(want.num_points) > 0 and not bool(want.ray_mask[-1])
