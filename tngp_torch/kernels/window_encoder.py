"""Binned window encoder — the port of `tngp/kernels/window_encoder.py`
(`bin_dest`, `bin_dest_pallas`, `_wob_local`, and `window_encode_binned` with
its forward `_binned_fwd` and its table-gradient backward `_binned_bwd`).

Forward pipeline, as `_binned_fwd` does it:
  1. bin: counting-sort the M samples into 64 spatial tiles, each tile's
     region padded to whole blocks, so every block of `block` samples is
     tile-pure (`bin_dest`, through the bin-sort kernels);
  2. sort: scatter the (x, y, z, 1) payload rows to `dest` — unique indices,
     so the scatter-add IS the sort, and padding slots stay zero, which is
     the validity channel;
  3. encode the sorted samples, each block with its tile's window per level
     (the window-encoder forward kernel);
  4. unsort with a gather on `dest`.

Backward, as `_binned_bwd`: sort the cotangent rows to `dest` with the same
scatter-add, then add every corner's `bf16(w * g)` into the table gradient
(the window-encoder backward kernel).  With `input_grads=True` (D-NeRF, whose
canonical encode happens at x + dx) positions get their gradient too: per
sorted sample the derivative-weight encode contracted with its cotangents
(the input-gradient kernel, which replaces the JAX package's three
`deriv=0,1,2` forward passes and their contraction), then unsorted.  Without
it positions get none, as the JAX package's default.

A dense level's corner row outside the window (a sample outside the unit
cube) contributes nothing in all three passes, as in the TPU kernels
(`ops/window_table.py` `_corner_rows`).

Numerics: by default the TPU's bf16 MXU pass (corner values and weights, or
the backward's products, rounded to bf16; f32 sums).  `mxu_f32=True` is the
JAX package's true-f32 form (`Precision.HIGHEST`, the plain
`window_encode_ref(emulate_bf16=False)`): nothing rounds to bf16, and the
three kernels run their f32 form (`window_encode_{fwd,bwd,dx}_f32`, the same
CUDA kernels with the template flag F32).

Kernels (CUDA sources in `tngp_torch/csrc/`; each header says what bounds it):
  `bin_dest`           -> bin_rank.cu        (replaces `_make_bin_rank_kernel`
                          and the scans around it)
  `window_encode_fwd`  -> window_encoder.cu  (replaces `_make_fwd_kernel`)
  `window_encode_bwd`  -> window_encoder.cu  (replaces `_make_bwd_kernel`)
  `window_encode_dx`   -> window_encoder.cu  (replaces `_make_fwd_kernel`
                          with `deriv=0,1,2` and the contraction after it)
Each has its plain PyTorch version beside it (`*_plain`; `bin_dest_ref`).
"""

from __future__ import annotations

import functools

import torch

from ..ops.window_table import (
    N_TILES,
    WIN_HI,
    WIN_LANES,
    WIN_ROWS,
    WindowSpec,
    _bf16_round,
    _corner_rows,
    sample_tiles,
)
from . import _lib
from .scatter import scatter_add

DEFAULT_BLOCK = 512
RANK_BS = 512  # keys per bin-rank block (fixed in bin_rank.cu)

BIN_DEST = _lib.register(
    "bin_dest", "bin_rank.cu", "tngp/kernels/window_encoder.py:131", "tngp_bin_dest"
)
WINDOW_FWD = _lib.register(
    "window_encode_fwd", "window_encoder.cu", "tngp/kernels/window_encoder.py:336",
    "tngp_window_encode_fwd",
)
WINDOW_BWD = _lib.register(
    "window_encode_bwd", "window_encoder.cu", "tngp/kernels/window_encoder.py:396",
    "tngp_window_encode_bwd",
)
WINDOW_DX = _lib.register(
    "window_encode_dx", "window_encoder.cu", "tngp/kernels/window_encoder.py:633",
    "tngp_window_encode_dx",
)
# the f32 forms (`mxu_f32=True`: `_mxu_precision` HIGHEST, :318-329, chosen
# at :582 and :613)
WINDOW_FWD_F32 = _lib.register(
    "window_encode_fwd_f32", "window_encoder.cu", "tngp/kernels/window_encoder.py:336",
    "tngp_window_encode_fwd_f32",
)
WINDOW_BWD_F32 = _lib.register(
    "window_encode_bwd_f32", "window_encoder.cu", "tngp/kernels/window_encoder.py:396",
    "tngp_window_encode_bwd_f32",
)
WINDOW_DX_F32 = _lib.register(
    "window_encode_dx_f32", "window_encoder.cu", "tngp/kernels/window_encoder.py:633",
    "tngp_window_encode_dx_f32",
)


def padded_size(M: int, block: int) -> int:
    """Static upper bound on the tile-padded sample count."""
    return -(-(M + N_TILES * (block - 1)) // block) * block


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _padded_keys(key: torch.Tensor) -> torch.Tensor:
    """[M] tile keys -> [NBk * RANK_BS] int32, padded with -1 (no tile)."""
    padm = (-key.shape[0]) % RANK_BS
    keyp = key.to(torch.int32)
    if padm:
        keyp = torch.cat([keyp, keyp.new_full((padm,), -1)])
    return keyp.contiguous()


def bin_ranks_plain(keyp: torch.Tensor):
    """Plain version of the bin-rank kernel: per block of RANK_BS keys, each
    key's stable rank within its tile (-1 for padding) and the block's tile
    histogram.  keyp [NBk * RANK_BS] int32 -> (rank [NBk * RANK_BS] int32,
    tot [NBk, 64] int32)."""
    NBk = keyp.shape[0] // RANK_BS
    tiles = torch.arange(N_TILES, dtype=torch.int32, device=keyp.device)
    onehot = (keyp.reshape(NBk, RANK_BS, 1) == tiles).to(torch.int32)  # [NBk, BS, 64]
    cum = torch.cumsum(onehot, dim=1)
    own = (cum * onehot).sum(dim=2)  # own rank + 1, 0 for padding
    return (own - 1).to(torch.int32).reshape(-1), cum[:, -1, :].to(torch.int32)


def _dest_from_ranks(key, rank, tot, M: int, block: int):
    """Counting-sort destinations from per-block ranks and histograms (the
    host-side half of `bin_dest_pallas`).  All integer, exact."""
    M_pad = padded_size(M, block)
    NB = M_pad // block
    tot = tot.long()
    blk_base = torch.cumsum(tot, dim=0) - tot  # exclusive [NBk, 64]
    counts = tot.sum(dim=0)  # [64]
    padded = (counts + block - 1) // block * block
    starts = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)[:-1]])
    sidx = torch.arange(M, device=key.device)
    base_s = blk_base.reshape(-1)[(sidx // RANK_BS) * N_TILES + key]
    dest = starts[key] + base_s + rank[:M].long()
    b_start = torch.arange(NB, device=key.device) * block
    tob = (starts[None, :] <= b_start[:, None]).sum(dim=1) - 1  # [NB]
    return dest, tob


def bin_dest_ref(x01_cf: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Plain port of the JAX `bin_dest`: the within-tile ranks from a
    one-hot cumulative sum.  Returns (dest [M] int64, an injection into
    [0, M_pad), tob [NB] int64 tile of each block)."""
    key = sample_tiles(x01_cf)
    return _dest_from_ranks(key, *bin_ranks_plain(_padded_keys(key)),
                            x01_cf.shape[1], block)


def bin_dest_stages(x01_cf: torch.Tensor, block: int = DEFAULT_BLOCK):
    """`bin_dest` through the bin-sort kernels, with what their first stage
    left behind: (dest, tob, rank [NBk * RANK_BS] int32, tot [NBk, 64]
    int32), the last two as `bin_ranks_plain` gives them for the padded
    keys.  One call of three kernels (ranks and histograms per key block,
    the scans, the destinations) and nothing in torch between them; x01_cf
    [3, M] f32 on the card, any strides."""
    if x01_cf.device.type != "cuda":
        raise ValueError(f"x01_cf: expected a CUDA tensor, got {x01_cf.device}")
    if x01_cf.dtype != torch.float32:
        raise TypeError(f"x01_cf: expected torch.float32, got {x01_cf.dtype}")
    if x01_cf.dim() != 2 or x01_cf.shape[0] != 3:
        raise ValueError(f"x01_cf: expected shape (3, M), got {tuple(x01_cf.shape)}")
    if block <= 0:
        raise ValueError(f"block {block} is not positive")
    M = x01_cf.shape[1]
    NB = padded_size(M, block) // block
    NBk = -(-M // RANK_BS)
    n_rank, n_tot = NBk * RANK_BS, NBk * N_TILES
    # one int64 buffer: dest, tob, then the int32 scratch (rank, tot, base
    # [NBk, 64], the tile counts [64])
    buf = torch.empty((M + NB + (n_rank + 2 * n_tot + N_TILES) // 2,), dtype=torch.int64,
                      device=x01_cf.device)
    dest, tob = buf[:M], buf[M:M + NB]
    scratch = buf[M + NB:].view(torch.int32)
    rank, tot = scratch[:n_rank], scratch[n_rank:n_rank + n_tot]
    _lib.launch(
        BIN_DEST, x01_cf.device,
        x01_cf.data_ptr(), x01_cf.stride(0), x01_cf.stride(1), M, block, NB,
        rank.data_ptr(), tot.data_ptr(), scratch[n_rank + n_tot:].data_ptr(),
        scratch[n_rank + 2 * n_tot:].data_ptr(), dest.data_ptr(), tob.data_ptr(),
    )
    return dest, tob, rank, tot.view(NBk, N_TILES)


def bin_dest(x01_cf: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Counting-sort destinations of the samples into tile-pure blocks (the
    counterpart of `bin_dest_pallas`); same contract as `bin_dest_ref`,
    which CPU tensors take.  CUDA tensors launch the bin-sort kernels
    (`bin_dest_stages`)."""
    if _lib.use_plain(x01_cf):
        return bin_dest_ref(x01_cf, block)
    return bin_dest_stages(x01_cf, block)[:2]


# ---------------------------------------------------------------------------
# encoder forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _level_consts(spec: WindowSpec, device: str):
    """(scales f32 [L], iconst int32 [4, L] = side, dense, window offset,
    windows, twin int64 [L, 64]) on `device`."""
    scales, sides, dense, twin, woff = spec.const_tables()
    nwin = [spec.level_n_win(l) for l in range(spec.num_levels)]
    iconst = torch.stack([torch.as_tensor(a) for a in (sides, dense, woff, nwin)])
    return (
        torch.as_tensor(scales).to(device),
        iconst.to(torch.int32).contiguous().to(device),
        torch.as_tensor(twin).long().to(device),
    )


def _wob_local(spec: WindowSpec, tob: torch.Tensor) -> torch.Tensor:
    """[L, NB] int32 within-level window index of each block.  The blocks
    are sorted by tile and a level's tile -> window map is nondecreasing, so
    each row is nondecreasing: the encoder kernels rely on it."""
    twin = _level_consts(spec, str(tob.device))[2]  # [L, 64]
    return twin[:, tob].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# the encoder kernels' chunks (tests/test_torch_window_schedule.py states
# the table gradient's work decomposition over them)
# ---------------------------------------------------------------------------

CHUNKS_PER_LEVEL = 128  # CUDA blocks per level the chunk size aims at
MAX_CHUNK_BLOCKS = 16  # MAX_CHUNK in window_encoder.cu


@functools.lru_cache(maxsize=None)
def chunk_blocks(n_blocks: int) -> int:
    """S, the tile-sorted blocks per chunk (one CUDA block per chunk and
    level in the forward and the table gradient): about CHUNKS_PER_LEVEL
    chunks per level, from the sample count alone (the launch reads nothing
    from the device)."""
    return max(1, min(MAX_CHUNK_BLOCKS, -(-n_blocks // CHUNKS_PER_LEVEL)))


@functools.lru_cache(maxsize=None)
def _table_shape(spec: WindowSpec) -> tuple:
    """[NW, C, 128, 64], cached: `spec.n_windows` costs ~20 us of host time."""
    return (spec.n_windows, spec.level_dim, WIN_LANES, WIN_HI)


def _check_encoder_call(xyz4, wob, spec: WindowSpec, block: int, **tensors):
    """Raise on what the CUDA encoder kernels do not take; returns M_pad."""
    L, C = spec.num_levels, spec.level_dim
    M_pad = xyz4.shape[0]
    if C not in (1, 2, 4, 8):
        raise ValueError(f"level_dim {C}: the encoder kernels take 1, 2, 4 or 8 channels")
    if block <= 0 or M_pad % block:
        raise ValueError(f"M_pad {M_pad} is not a multiple of block {block}")
    _lib.check(xyz4, "xyz4", torch.float32, (M_pad, 4))
    _lib.check(wob, "wob", torch.int32, (L, M_pad // block))
    for name, t in tensors.items():
        _lib.check(t, name, torch.float32,
                   (M_pad, L * C) if name == "g_sorted" else _table_shape(spec))
    _check_aligned(xyz4, "xyz4")
    return M_pad


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless `t` starts on 16 bytes: the kernels read it as float4."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def sorted_corner_addresses(xyz4, wob, spec: WindowSpec, block: int, level: int,
                            deriv: bool = False):
    """Where the 8 corners of every tile-sorted sample live at `level`:
    (addr [8, M_pad] int64 flat index of channel 0 into the window-layout
    table, channel c is `addr + c * 8192`; w [8, M_pad] f32 interpolation
    weights with the validity channel folded in) and, with `deriv`, the
    derivative weights [3, 8, M_pad] (validity folded in) as a third entry."""
    M_pad = xyz4.shape[0]
    geo = _corner_rows(spec, level, xyz4[:, :3].T, deriv=deriv)
    rows, valid = geo[0], xyz4[:, 3]
    blk = torch.arange(M_pad, device=xyz4.device) // block
    win = spec.win_offsets[level] + wob[level].long()[blk]  # [M_pad]
    off = (rows & (WIN_LANES - 1)) * WIN_HI + (rows >> 7)  # [8, M_pad]
    addr = win * (spec.level_dim * WIN_ROWS) + off
    return (addr, *(w * valid for w in geo[1:]))


def _operand(x: torch.Tensor, mxu_f32: bool) -> torch.Tensor:
    """A corner operand as the numerics use it: bf16-rounded by default,
    unrounded in the f32 form."""
    return x if mxu_f32 else _bf16_round(x)


def window_encode_fwd_plain(xyz4, wob, table_win, spec: WindowSpec, block: int,
                            mxu_f32: bool = False):
    """Plain version of the encoder-forward kernel.

    xyz4 [M_pad, 4] f32 (x01, y01, z01, valid) in tile-pure blocks; wob
    [L, NB] int32; table_win [NW, C, 128, 64] f32.  Returns [L*C, M_pad] f32
    with bf16-rounded corner values and weights (unrounded with `mxu_f32`),
    f32 products and sums."""
    flat = table_win.float().reshape(-1)
    outs = []
    for l in range(spec.num_levels):
        addr, ws = sorted_corner_addresses(xyz4, wob, spec, block, l)
        ws = _operand(ws, mxu_f32)
        for c in range(spec.level_dim):
            vals = _operand(flat[addr + c * WIN_ROWS], mxu_f32)
            outs.append(torch.sum(ws * vals, dim=0))
    return torch.stack(outs)


def window_encode_fwd(xyz4, wob, table_win, spec: WindowSpec, block: int,
                      mxu_f32: bool = False):
    """Encoder forward over tile-sorted samples (see
    `window_encode_fwd_plain`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (its f32 form with `mxu_f32`): one CUDA block
    per (chunk, level), each run of one window within the chunk staged once
    in shared memory, as bf16 or f32 (a one-block run of mostly padding
    gathers from global memory instead); the same values, corners summed in
    the same order.  Raises on what the kernel does not take
    (`_check_encoder_call`)."""
    if _lib.use_plain(xyz4):
        return window_encode_fwd_plain(xyz4, wob, table_win, spec, block, mxu_f32)
    L, C = spec.num_levels, spec.level_dim
    M_pad = _check_encoder_call(xyz4, wob, spec, block, table_win=table_win)
    _check_aligned(table_win, "table_win")  # staged with 16-byte loads
    scales, iconst, _ = _level_consts(spec, str(xyz4.device))
    out = torch.empty((L * C, M_pad), dtype=torch.float32, device=xyz4.device)
    _lib.launch(
        WINDOW_FWD_F32 if mxu_f32 else WINDOW_FWD, xyz4.device,
        xyz4.data_ptr(), wob.data_ptr(), table_win.data_ptr(),
        scales.data_ptr(), iconst.data_ptr(), out.data_ptr(),
        M_pad, block, L, C, chunk_blocks(M_pad // block), spec.shift,
        int(spec.interpolation == "smoothstep"),
    )
    return out


def window_encode_bwd_plain(xyz4, wob, g_sorted, spec: WindowSpec, block: int,
                            mxu_f32: bool = False):
    """Plain version of the encoder-backward kernel.

    xyz4 [M_pad, 4] f32 and wob [L, NB] int32 as the forward; g_sorted
    [M_pad, L*C] f32 cotangent rows in the sorted order.  Returns the table
    gradient [NW, C, 128, 64] f32: each corner adds `bf16(w * valid * g)`,
    one rounding of the product (with `mxu_f32` the f32 product), summed in
    f32; windows no block visits and rows no sample touches are zero."""
    M_pad = xyz4.shape[0]
    L, C = spec.num_levels, spec.level_dim
    out = torch.zeros((spec.n_windows * C * WIN_ROWS,), dtype=torch.float32,
                      device=xyz4.device)
    g = g_sorted.float().reshape(M_pad, L, C)
    for l in range(L):
        addr, ws = sorted_corner_addresses(xyz4, wob, spec, block, l)
        for c in range(C):
            contrib = _operand(ws * g[:, l, c], mxu_f32)  # [8, M_pad]
            out.index_add_(0, (addr + c * WIN_ROWS).reshape(-1), contrib.reshape(-1))
    return out.reshape(spec.n_windows, C, WIN_LANES, WIN_HI)


def window_encode_bwd(xyz4, wob, g_sorted, spec: WindowSpec, block: int,
                      mxu_f32: bool = False):
    """Table gradient over tile-sorted samples (see
    `window_encode_bwd_plain`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (its f32 form with `mxu_f32`), which writes
    every entry: each chunk's piece
    (a whole run of one window of at most 2 S blocks, or a longer run's part
    within the chunk: `encoder_pieces` in tests/test_torch_window_schedule.py)
    accumulates its window in shared memory and stores it (a whole run) or
    adds it into the window (zeroed first, with every unvisited window, by a
    small kernel in the same call).  Each entry matches the ordered sum to
    f32 reordering error."""
    if _lib.use_plain(xyz4):
        return window_encode_bwd_plain(xyz4, wob, g_sorted, spec, block, mxu_f32)
    L, C = spec.num_levels, spec.level_dim
    M_pad = _check_encoder_call(xyz4, wob, spec, block, g_sorted=g_sorted)
    scales, iconst, _ = _level_consts(spec, str(xyz4.device))
    gtab = torch.empty(_table_shape(spec), dtype=torch.float32, device=xyz4.device)
    _lib.launch(
        WINDOW_BWD_F32 if mxu_f32 else WINDOW_BWD, xyz4.device,
        xyz4.data_ptr(), wob.data_ptr(), g_sorted.data_ptr(),
        scales.data_ptr(), iconst.data_ptr(), gtab.data_ptr(),
        M_pad, block, L, C, chunk_blocks(M_pad // block), spec.shift,
        int(spec.interpolation == "smoothstep"),
    )
    return gtab


def dx_features(xyz4, wob, table_win, spec: WindowSpec, block: int,
                mxu_f32: bool = False) -> torch.Tensor:
    """The derivative-weight encode of tile-sorted samples: d [3, L*C, M_pad]
    f32, d[j] = d features / d x01_j with each corner's table value and
    derivative weight rounded to bf16 (unrounded with `mxu_f32`) and the 8
    products summed in corner order in f32 (the TPU kernel's `deriv=j`
    value)."""
    flat = table_win.float().reshape(-1)
    L, C = spec.num_levels, spec.level_dim
    d = [[], [], []]
    for l in range(L):
        addr, _, dws = sorted_corner_addresses(xyz4, wob, spec, block, l, deriv=True)
        dws = _operand(dws, mxu_f32)  # [3, 8, M_pad]
        for c in range(C):
            vals = _operand(flat[addr + c * WIN_ROWS], mxu_f32)  # [8, M_pad]
            for j in range(3):
                acc = dws[j, 0] * vals[0]
                for k in range(1, 8):
                    acc = acc + dws[j, k] * vals[k]
                d[j].append(acc)
    return torch.stack([torch.stack(dj) for dj in d])


def window_encode_dx_plain(xyz4, wob, table_win, g_sorted, spec: WindowSpec, block: int,
                           mxu_f32: bool = False):
    """Plain version of the input-gradient kernel.

    xyz4, wob and table_win as the forward; g_sorted [M_pad, L*C] f32 as the
    backward.  Returns gx [3, M_pad] f32: gx_j = `(g_sorted.T * d[j]).sum(0)`
    with d = `dx_features(...)`, the JAX package's contraction."""
    d = dx_features(xyz4, wob, table_win, spec, block, mxu_f32)
    return (g_sorted.float().T[None] * d).sum(1)


DX_GROUP_LEVELS = 2  # levels per CUDA block of the input gradient
DX_MAX_CHUNK_SAMPLES = 4096  # S * block, at most (DX_MAX_CHUNK_SAMPLES in window_encoder.cu)


@functools.lru_cache(maxsize=None)
def dx_schedule(n_blocks: int, n_levels: int, block: int) -> tuple[int, int]:
    """(S, LG) of the input-gradient kernel: one CUDA block per (chunk of S
    tile-sorted blocks, group of LG levels), the chunks as the forward's
    (`chunk_blocks`, within the kernel's room for S * block sums), from the
    sample count alone."""
    return (max(1, min(chunk_blocks(n_blocks), DX_MAX_CHUNK_SAMPLES // block)),
            min(DX_GROUP_LEVELS, n_levels))


def window_encode_dx(xyz4, wob, table_win, g_sorted, spec: WindowSpec, block: int,
                     mxu_f32: bool = False):
    """Input gradient over tile-sorted samples (see `window_encode_dx_plain`).
    CPU tensors take the plain version; CUDA tensors launch the kernel (its
    f32 form with `mxu_f32`): one CUDA block per (chunk, group of levels)
    that stages each run's window once in shared memory, then, with more than one group, a second
    kernel adds the groups' partial sums in group order.  Each sample's L*C
    terms are added in (level, channel) order within a group and the groups
    in order, so two calls give the same bits.  Raises on what the kernel does not
    take (`_check_encoder_call`; blocks of more than DX_MAX_CHUNK_SAMPLES)."""
    if _lib.use_plain(xyz4):
        return window_encode_dx_plain(xyz4, wob, table_win, g_sorted, spec, block, mxu_f32)
    L, C = spec.num_levels, spec.level_dim
    M_pad = _check_encoder_call(xyz4, wob, spec, block, table_win=table_win,
                                g_sorted=g_sorted)
    if block > DX_MAX_CHUNK_SAMPLES:
        raise ValueError(f"block {block}: the input-gradient kernel takes at most "
                         f"{DX_MAX_CHUNK_SAMPLES} samples per block")
    scales, iconst, _ = _level_consts(spec, str(xyz4.device))
    S, LG = dx_schedule(M_pad // block, L, block)
    groups = -(-L // LG)
    # gx, then the groups' partial sums where there is more than one
    buf = torch.empty((3 * M_pad * (1 + groups * (groups > 1)),), dtype=torch.float32,
                      device=xyz4.device)
    gx = buf[:3 * M_pad].view(3, M_pad)
    _lib.launch(
        WINDOW_DX_F32 if mxu_f32 else WINDOW_DX, xyz4.device,
        xyz4.data_ptr(), wob.data_ptr(), table_win.data_ptr(), g_sorted.data_ptr(),
        scales.data_ptr(), iconst.data_ptr(), buf[3 * M_pad:].data_ptr(), gx.data_ptr(),
        M_pad, block, L, C, S, LG, spec.shift, int(spec.interpolation == "smoothstep"),
    )
    return gx


class _WindowEncodeBinned(torch.autograd.Function):
    """`window_encode_binned` with the table gradient of `_binned_bwd` and,
    with `input_grads`, the positions' gradient."""

    @staticmethod
    def forward(ctx, x01_cf, table_win, spec, block, input_grads, mxu_f32):
        M = x01_cf.shape[1]
        dest, tob = bin_dest(x01_cf, block=block)
        M_pad = padded_size(M, block)
        payload = torch.cat(
            [x01_cf.float(), x01_cf.new_ones((1, M), dtype=torch.float32)]
        ).T.contiguous()  # [M, 4]
        xyz4 = scatter_add(dest, payload, M_pad, indices="unique")  # [M_pad, 4]
        wob = _wob_local(spec, tob)  # [L, NB]
        table = table_win.float().contiguous()
        feats_sorted = window_encode_fwd(xyz4, wob, table, spec, block, mxu_f32)  # [LC, M_pad]
        # the table is kept only for the input gradient
        ctx.save_for_backward(xyz4, dest, wob, table if input_grads else None)
        ctx.spec, ctx.block, ctx.input_grads, ctx.mxu_f32 = spec, block, input_grads, mxu_f32
        return feats_sorted.index_select(1, dest)  # [LC, M] unsort

    @staticmethod
    def backward(ctx, g):
        want_x = ctx.input_grads and ctx.needs_input_grad[0]
        if not (want_x or ctx.needs_input_grad[1]):
            return None, None, None, None, None, None
        xyz4, dest, wob, table = ctx.saved_tensors
        # sort the cotangents the way the inputs were sorted: rows [M, LC]
        # (g may arrive non-contiguous) -> [M_pad, LC], unique indices
        g_sorted = scatter_add(dest, g.float().T.contiguous(), xyz4.shape[0],
                               indices="unique")
        gtab = gx = None
        if ctx.needs_input_grad[1]:
            gtab = window_encode_bwd(xyz4, wob, g_sorted, ctx.spec, ctx.block, ctx.mxu_f32)
        if want_x:
            gx_sorted = window_encode_dx(xyz4, wob, table, g_sorted, ctx.spec, ctx.block,
                                         ctx.mxu_f32)
            gx = gx_sorted.index_select(1, dest)  # [3, M] unsort
        return gx, gtab, None, None, None, None


def window_encode_binned(
    x01_cf: torch.Tensor,
    table_win: torch.Tensor,
    spec: WindowSpec,
    block: int = DEFAULT_BLOCK,
    input_grads: bool = False,
    mxu_f32: bool = False,
) -> torch.Tensor:
    """Windowed grid encode through the binned path.

    x01_cf: [3, M], in [0,1] for NGP (samples outside contribute nothing at
    the dense levels' out-of-range corners); table_win: [NW, C, 128, 64].
    Returns [L*C, M] f32, level-major, with the bf16 corner numerics of the
    TPU default, or with `mxu_f32=True` the true-f32 numerics of the JAX
    package's option of that name (the f32 form of all three kernels).
    Table gradients flow (in the window layout); positions get theirs only
    with `input_grads=True`, as the JAX package's option."""
    return _WindowEncodeBinned.apply(x01_cf, table_win, spec, block, input_grads, mxu_f32)
