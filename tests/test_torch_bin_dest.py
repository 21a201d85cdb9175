"""The bin sort's three stages, as the CUDA kernels in
`tngp_torch/csrc/bin_rank.cu` compute them, mirrored line by line in numpy
and held exactly against the JAX package's `bin_dest`
(`tngp/kernels/window_encoder.py`):

1. `bin_rank_kernel`: per block of 512 keys (the key formed from x01 with
   `sample_tiles`' floor, clamp and NaN -> 0 rule; -1 past M), each key's
   rank among the lanes of its warp with the same key, plus the counts of
   the earlier warps, and the block's 64-bin histogram;
2. `bin_scan_kernel`, one block per tile column: the exclusive scan of the
   column of histograms down the key blocks (each thread a run of
   R = ceil(NBk / 1024) rows: the runs' sums, their block-wide exclusive
   scan, then each run rescanned) and the column's total, the tile count;
3. `bin_dest_kernel`: the block-padded exclusive scan of the counts,
   `starts` (two tiles a lane of one warp), each block's tile `tob`, and
   dest = starts[key] + base[key block, key] + rank.

Cases: M not a multiple of 512, every sample in one tile, most tiles empty,
NaN and infinite coordinates, M = 1.  The port's CPU `bin_dest` (its plain
version) is held to the same answer; the kernels themselves are held to it
on the card (`tests/test_torch_kernels_gpu.py`, `chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import torch

from tngp.kernels.window_encoder import bin_dest as jax_bin_dest
from tngp_torch.kernels import window_encoder as wk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RANK_BS, N_TILES, SCAN_THREADS = 512, 64, 1024


def _tile_key(x01):
    """`tile_key`: per dimension floor(x * 4) clamped to [0, 3], NaN -> 0."""
    t = np.clip(np.floor(np.nan_to_num(x01, nan=0.0, posinf=np.inf, neginf=-np.inf) * 4), 0, 3)
    t = t.astype(np.int64)
    return (t[0] * 4 + t[1]) * 4 + t[2]


def _stage1(key, M):
    """`bin_rank_kernel`: rank [NBk * 512] (-1 past M), tot [NBk, 64]."""
    NBk = -(-M // RANK_BS)
    keys = np.full(NBk * RANK_BS, -1, np.int64)
    keys[:M] = key
    rank = np.full(NBk * RANK_BS, -1, np.int64)
    tot = np.zeros((NBk, N_TILES), np.int64)
    for b in range(NBk):
        hist = np.zeros((RANK_BS // 32, N_TILES), np.int64)
        within = np.zeros(RANK_BS, np.int64)
        for warp in range(RANK_BS // 32):
            lanes = keys[b * RANK_BS + 32 * warp:b * RANK_BS + 32 * warp + 32]
            for lane in range(32):
                peers = lanes == lanes[lane]  # __match_any_sync
                within[32 * warp + lane] = int(peers[:lane].sum())  # popcount of the lower
                if lanes[lane] >= 0 and lane == int(np.argmax(peers)):  # the first peer
                    hist[warp, lanes[lane]] = int(peers.sum())
        for t in range(RANK_BS):
            key_t = keys[b * RANK_BS + t]
            if key_t >= 0:
                rank[b * RANK_BS + t] = within[t] + hist[:t // 32, key_t].sum()
        tot[b] = hist.sum(axis=0)
    return rank, tot


def _stage2(tot):
    """`bin_scan_kernel`: base [NBk, 64], counts [64]."""
    NBk = tot.shape[0]
    R = -(-NBk // SCAN_THREADS)
    base = np.zeros_like(tot)
    counts = np.zeros(N_TILES, np.int64)
    for c in range(N_TILES):  # one block per column
        runs = [(min(NBk, t * R), min(NBk, t * R + R)) for t in range(SCAN_THREADS)]
        sums = np.array([tot[r0:r1, c].sum() for r0, r1 in runs], np.int64)
        incl = np.cumsum(sums)  # block_inclusive_scan
        for (r0, r1), s in zip(runs, incl - sums):
            for r in range(r0, r1):
                base[r, c] = s
                s += tot[r, c]
        counts[c] = incl[-1]
    return base, counts


def _stage3(x01, rank, base, counts, NB, block):
    """`bin_dest_kernel`: starts from the counts (lane l of one warp holds
    tiles 2 l and 2 l + 1: their padded sum, scanned), tob, dest."""
    padded = (counts + block - 1) // block * block
    pair = np.cumsum(padded[0::2] + padded[1::2])  # the warp's inclusive scan
    starts = np.empty(N_TILES, np.int64)
    starts[0::2] = pair - padded[0::2] - padded[1::2]
    starts[1::2] = pair - padded[1::2]
    tob = np.array([int((starts <= b * block).sum()) - 1 for b in range(NB)], np.int64)
    key = _tile_key(x01)
    M = x01.shape[1]
    dest = starts[key] + base[np.arange(M) // RANK_BS, key] + rank[:M]
    return dest, tob


def _bin_dest_mirror(x01, block):
    M = x01.shape[1]
    rank, tot = _stage1(_tile_key(x01), M)
    base, counts = _stage2(tot)
    dest, tob = _stage3(x01, rank, base, counts, wk.padded_size(M, block) // block, block)
    return dest, tob, rank, tot


def _x01(case, M, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, M)).astype(np.float32)
    if case == "one_tile":
        x *= 0.24
    elif case == "empty_tiles":  # samples only in the tiles of x < 1/2, y < 1/4
        x[0] *= 0.5
        x[1] *= 0.25
    elif case == "nan_inf":
        x[0, ::7] = np.nan
        x[1, 1::5] = np.inf
        x[2, 2::9] = -np.inf
        x[1, 3::11] = 1.5
        x[2, 4::13] = -0.25
    return x


MIRROR_CASES = [
    ("uniform", 1100, 512), ("uniform", 1, 512), ("uniform", 1024, 64),
    ("one_tile", 1500, 512), ("empty_tiles", 700, 128), ("nan_inf", 1300, 512),
]


def check_three_stage_mirror_matches_jax_bin_dest(case, M, block):
    """The three stages mirrored in numpy against JAX's `bin_dest`,
    exactly (`test_torch_bin_dest_{1,2}.py` run the cases)."""
    x = _x01(case, M, seed=M + block)
    dest, tob, rank, tot = _bin_dest_mirror(x, block)
    d_j, t_j = jax_bin_dest(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(dest, np.asarray(d_j))
    np.testing.assert_array_equal(tob, np.asarray(t_j))
    # the first stage is `bin_ranks_plain` on the padded keys
    xt = torch.from_numpy(x)
    r_p, t_p = wk.bin_ranks_plain(wk._padded_keys(wk.sample_tiles(xt)))
    np.testing.assert_array_equal(rank, r_p.numpy())
    np.testing.assert_array_equal(tot, t_p.numpy())
    # the port's CPU bin_dest, and an injection into [0, M_pad)
    d_p, t_pt = wk.bin_dest(xt, block=block)
    np.testing.assert_array_equal(d_p.numpy(), dest)
    np.testing.assert_array_equal(t_pt.numpy(), tob)
    assert len(set(dest.tolist())) == M and int(dest.max()) < wk.padded_size(M, block)


def check_scan_runs_cover_every_row_once():
    """Stage 2's runs (one per thread of a column's block, R = ceil(NBk /
    1024) rows each, the last ones short or empty) cover rows [0, NBk) once
    and in order, for the key block counts of M = 1 .. past the eval's top
    width (NBk 768) and past one row a thread."""
    for NBk in (0, 1, 15, 768, 1024, 1025, 4097):
        R = -(-NBk // SCAN_THREADS)
        rows = [r for t in range(SCAN_THREADS)
                for r in range(min(NBk, t * R), min(NBk, t * R + R))]
        assert rows == list(range(NBk))
