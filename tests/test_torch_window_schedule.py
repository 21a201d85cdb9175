"""The window-encoder kernels' work decomposition, on the CPU.

The table-gradient kernel (`tngp_torch/csrc/window_encoder.cu`) takes one
CUDA block per (chunk, level) and walks the runs of one window in `wob[l]`
(the forward takes the same chunks and stages each run's window within
its chunk); `encoder_pieces` below states the walk's rule.  These tests
hold:
the rows of `wob` that `bin_dest` gives are nondecreasing (the walk and the
zeroing kernel's binary search rely on it); the pieces cover every
(level, block) once, each in one window, a whole short run stores and a
long run's pieces add; a line-by-line mirror of the device walk (`ChunkWalk`,
with its bounded stretch of `wob[l]` in shared memory) gives the same
pieces; and an emulation of the table gradient's accumulation per piece
(store or add flush, zeroing of long and unvisited windows) matches
`window_encode_bwd_plain` within the per-entry reordering bound; an entry
of at most two terms has one f32 sum in any order.  No JAX:
`tests/test_torch_window_encoder*.py` hold the plain versions against the
JAX package."""

import numpy as np
import pytest
import torch

from tngp_torch.kernels import window_encoder as kw
from tngp_torch.ops import window_table as wt
from tngp_torch.ops.window_table import WIN_ROWS

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPECS = {
    "flagship": dict(desired_resolution=2048),
    "small": dict(num_levels=5, level_dim=2, base_resolution=4, per_level_scale=2.0,
                  log2_hashmap_size=15),
}
INPUTS = {  # name -> (M, x01 from uniform [0, 1] draws u)
    "uniform": (20_000, lambda u: u),
    "crowded": (20_000, lambda u: u * 0.24),
    "out_of_range": (20_000, lambda u: u * 1.12 - 0.06),
    "tiny": (37, lambda u: u),
}


def _sorted(spec_name, input_name, seed=0):
    """(spec, xyz4, wob, g_sorted) as `window_encode_binned` makes them."""
    spec = wt.WindowSpec.create(**SPECS[spec_name])
    M, make = INPUTS[input_name]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(make(rng.uniform(0, 1, (3, M))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(M, spec.output_dim)).astype(np.float32))
    dest, tob = kw.bin_dest(x)
    M_pad = kw.padded_size(M, kw.DEFAULT_BLOCK)
    payload = torch.cat([x, torch.ones((1, M))]).T.contiguous()
    xyz4 = torch.zeros((M_pad, 4)).index_copy_(0, dest, payload)
    g_sorted = torch.zeros((M_pad, spec.output_dim)).index_copy_(0, dest, g)
    return spec, xyz4, kw._wob_local(spec, tob), g_sorted


def encoder_pieces(wob_row, S: int) -> list[tuple[int, int, int, bool]]:
    """The table-gradient kernel's work at one level: (chunk, b0, b1, store)
    per piece, ordered by chunk.  A run (a maximal stretch of blocks with
    one window; the row is nondecreasing, so one per visited window) of at
    most 2 S blocks is one piece, taken by the chunk of its first block,
    and stores its whole window; a longer run is cut at the chunk edges
    (chunk c holds blocks [c S, (c + 1) S)), and each piece adds into its
    window, which the zeroing kernel cleared first, as it clears every
    window no block visits."""
    w = [int(v) for v in wob_row]
    pieces, b0 = [], 0
    while b0 < len(w):
        b1 = b0 + 1
        while b1 < len(w) and w[b1] == w[b0]:
            b1 += 1
        if b1 - b0 <= 2 * S:
            pieces.append((b0 // S, b0, b1, True))
        else:
            pieces += [(c, max(b0, c * S), min(b1, (c + 1) * S), False)
                       for c in range(b0 // S, (b1 - 1) // S + 1)]
        b0 = b1
    return sorted(pieces)


def _device_walk(row, S, c):
    """`ChunkWalk` of window_encoder.cu line by line: chunk c's pieces from
    the stretch of the row it loads into shared memory."""
    NB = len(row)
    lo, hi = max(0, (c - 2) * S - 1), min(NB, (c + 3) * S + 1)
    sw = row[lo:hi]
    b, end, out = c * S, min(NB, (c + 1) * S), []
    while b < end:
        w = sw[b - lo]
        r0, r1 = b, b + 1
        while r0 > lo and sw[r0 - 1 - lo] == w:
            r0 -= 1
        while r1 < hi and sw[r1 - lo] == w:
            r1 += 1
        if r1 - r0 > 2 * S:
            out.append((c, b, min(r1, end), False))
            b = min(r1, end)
            continue
        b = r1
        if r0 < c * S:
            continue
        out.append((c, r0, r1, True))
    return out


def _check_pieces(row, S):
    """Coverage, one window per piece, store/add by run length, ownership."""
    row = [int(v) for v in row]
    NB = len(row)
    pieces = encoder_pieces(row, S)
    n_chunks = -(-NB // S)
    covered = np.zeros(NB, np.int64)
    for c, b0, b1, store in pieces:
        assert 0 <= c < n_chunks and b0 < b1
        covered[b0:b1] += 1
        assert len(set(row[b0:b1])) == 1, "a piece spans two windows"
        run = [b for b in range(NB) if row[b] == row[b0]]
        assert run == list(range(run[0], run[-1] + 1)), "a window in two runs"
        if store:  # the whole run, begun in its chunk
            assert (b0, b1) == (run[0], run[-1] + 1) and b1 - b0 <= 2 * S
            assert c * S <= b0 < (c + 1) * S
        else:  # a long run's piece, inside its chunk
            assert len(run) > 2 * S and c * S <= b0 and b1 <= (c + 1) * S
    assert (covered == 1).all(), "a block is covered other than once"
    walked = [p for c in range(n_chunks) for p in _device_walk(row, S, c)]
    assert walked == pieces
    return pieces


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("input_name", list(INPUTS))
def test_pieces_cover_every_block_once_in_one_window(spec_name, input_name):
    spec, xyz4, wob, _ = _sorted(spec_name, input_name)
    NB = wob.shape[1]
    S = kw.chunk_blocks(NB)
    assert 1 <= S <= kw.MAX_CHUNK_BLOCKS and -(-NB // S) <= kw.CHUNKS_PER_LEVEL
    assert bool((wob[:, 1:] >= wob[:, :-1]).all()), "a row of wob decreases"
    for l in range(spec.num_levels):
        assert int(wob[l].max()) < spec.level_n_win(l)
        _check_pieces(wob[l].tolist(), S)


@pytest.mark.parametrize("S", [1, 2, 5, 13, 16])
def test_device_walk_on_runs_around_the_long_threshold(S):
    """Rows built from run lengths 1 .. 3 S + 2 (2 S and 2 S + 1 included)
    and skipped windows, so that runs reach the edges of a chunk's loaded
    stretch of wob[l]."""
    rng = np.random.default_rng(S)
    lengths = list(rng.integers(1, 3 * S + 3, 60)) + [2 * S, 2 * S + 1, 1, 2 * S + 2]
    row, w = [], 0
    for n in lengths:
        row += [w] * int(n)
        w += int(rng.integers(1, 3))
    pieces = _check_pieces(row, S)
    assert any(p[3] for p in pieces) and not all(p[3] for p in pieces)


@pytest.mark.parametrize("spec_name,input_name",
                         [("small", name) for name in INPUTS]
                         + [("flagship", "uniform"), ("flagship", "crowded")])
def test_accumulation_per_piece_matches_plain(spec_name, input_name):
    """The table gradient as the kernel forms it: windows that no block
    visits, or whose run is long, zeroed first (a binary search per window,
    as the zeroing kernel); every other entry starts as NaN, so an entry no
    flush writes shows.  Per piece a window-sized accumulator takes the
    piece's bf16(w * g) terms, then stores (a whole short run) or adds
    (a long run's piece).  Against the plain version: each entry within
    2 (n - 1) 2^-24 sum|term| (two orders of its n terms) and the same
    zero pattern."""
    spec, xyz4, wob, g_sorted = _sorted(spec_name, input_name, seed=1)
    L, C, block = spec.num_levels, spec.level_dim, kw.DEFAULT_BLOCK
    NB = wob.shape[1]
    S = kw.chunk_blocks(NB)
    win_len = C * WIN_ROWS
    out = torch.full((spec.n_windows, win_len), float("nan"))
    n = torch.zeros(spec.n_windows * win_len)
    live = xyz4[:, 3] > 0
    for l in range(L):
        row = wob[l].numpy()
        for w in range(spec.level_n_win(l)):
            runlen = np.searchsorted(row, w, "right") - np.searchsorted(row, w, "left")
            if runlen == 0 or runlen > 2 * S:
                out[spec.win_offsets[l] + w] = 0.0
        addr, ws = kw.sorted_corner_addresses(xyz4, wob, spec, block, l)  # [8, M_pad]
        n.index_add_(0, addr[:, live].reshape(-1), torch.ones(int(live.sum()) * 8))
        g = g_sorted[:, l * C:(l + 1) * C]
        for _, b0, b1, store in encoder_pieces(row, S):
            m = slice(b0 * block, b1 * block)
            win = spec.win_offsets[l] + int(row[b0])
            acc = torch.zeros(win_len)
            off = addr[:, m] - win * win_len  # [8, m]
            assert bool(((off >= 0) & (off < WIN_ROWS)).all())
            for c in range(C):
                terms = wt._bf16_round(ws[:, m] * g[m, c])
                acc.index_add_(0, (off + c * WIN_ROWS).reshape(-1), terms.reshape(-1))
            out[win] = acc if store else out[win] + acc
    got = out.reshape(spec.n_windows, C, 128, 64)
    assert not bool(torch.isnan(got).any()), "an entry no flush or zeroing wrote"
    plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, block)
    sabs = kw.window_encode_bwd_plain(xyz4, wob, g_sorted.abs(), spec, block)
    n = n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(got.shape)
    tol = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double()
    assert bool(((got.double() - plain.double()).abs() <= tol).all())
    assert bool(((got == 0) == (plain == 0)).all()) and float(plain.abs().max()) > 0


@pytest.mark.parametrize("input_name", ["uniform", "crowded"])
def test_entries_of_two_terms_do_not_depend_on_the_order(input_name):
    """What `chip_smoke.py` holds the table-gradient kernel to, whose
    atomics order an entry's terms as they land: the plain version's sums
    taken in reverse order equal its own bitwise on every entry of at most
    two terms (`bwd_zero_pattern.term_counts`; an entry no sample touches
    is 0 in both) and stay within the reordering bound from three terms on,
    where the order can decide whether a cancellation leaves exactly 0."""
    from tngp_torch.diagnostics.bwd_zero_pattern import term_counts

    spec, xyz4, wob, g_sorted = _sorted("small", input_name, seed=2)
    L, C, block = spec.num_levels, spec.level_dim, kw.DEFAULT_BLOCK
    plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, block).reshape(-1)
    sabs = kw.window_encode_bwd_plain(xyz4, wob, g_sorted.abs(), spec, block).reshape(-1)
    g = g_sorted.reshape(-1, L, C)
    rev = torch.zeros_like(plain)
    for l in range(L):
        addr, ws = kw.sorted_corner_addresses(xyz4, wob, spec, block, l)
        for c in range(C):
            terms = wt._bf16_round(ws * g[:, l, c])
            rev.index_add_(0, (addr + c * WIN_ROWS).reshape(-1).flip(0),
                           terms.reshape(-1).flip(0))
    n = term_counts(xyz4, wob, spec, block)
    few = n <= 2
    assert torch.equal(rev[few], plain[few])
    assert bool((plain[n == 0] == 0).all()) and int((n >= 3).sum()) > 0
    tol = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double()
    assert bool(((rev.double() - plain.double()).abs() <= tol).all())
    # three terms whose order decides a zero: 1 + 2^-30 rounds to 1
    one, tiny = torch.tensor(1.0), torch.tensor(2.0**-30)
    assert float((one + tiny) - one) == 0.0 and float((one - one) + tiny) == 2.0**-30


def test_level_consts_carry_the_window_counts():
    spec = wt.WindowSpec.create(**SPECS["flagship"])
    _, iconst, _ = kw._level_consts(spec, "cpu")
    assert iconst.shape == (4, spec.num_levels)
    assert iconst[3].tolist() == [spec.level_n_win(l) for l in range(spec.num_levels)]
    assert iconst[2].tolist() == list(spec.win_offsets[:-1])
    assert [kw.chunk_blocks(nb) for nb in (1, 72, 128, 129, 320, 832, 10_000)] == \
        [1, 1, 1, 2, 3, 7, 16]


@pytest.mark.parametrize("input_name", ["tiny", "out_of_range"])
def test_encoder_bytes_count_the_table_entries_read(input_name):
    """The encoder's byte bound (`kernel_times.encoder_bytes`): the forward
    reads each table entry a live sample's corner weighs, counted here as the
    nonzero entries of the plain table gradient for unit cotangents (all
    weights are >= 0, so no sum cancels); the input gradient reads at least
    those and writes gx; the table gradient writes the whole table.  At a
    tiny width that is far below one read of each window the blocks visit."""
    from tngp_torch.diagnostics.kernel_times import encoder_bytes

    spec, xyz4, wob, _ = _sorted("small", input_name)
    block, M_pad, C = kw.DEFAULT_BLOCK, xyz4.shape[0], spec.level_dim
    samples = M_pad * (16 + 4 * spec.output_dim) + wob.numel() * 4
    read = kw.window_encode_bwd_plain(xyz4, wob, torch.ones((M_pad, spec.output_dim)), spec,
                                      block)
    fwd = encoder_bytes("fwd", xyz4, wob, spec, block)
    assert fwd == samples + 4 * int((read != 0).sum())
    assert encoder_bytes("dx", xyz4, wob, spec, block) >= fwd + 12 * M_pad
    assert encoder_bytes("bwd", xyz4, wob, spec, block) == samples + 4 * read.numel()
    if input_name == "tiny":
        visited = sum(int(torch.unique(wob[l]).numel()) for l in range(spec.num_levels))
        assert fwd - samples < visited * C * WIN_ROWS * 4 // 4


def _dx_mirror(xyz4, wob, table, g_sorted, spec, block):
    """`window_dx_kernel` and `window_dx_sum_kernel` line by line: per
    (chunk of S blocks, group of LG levels) and level, the chunk's runs of
    one window (heads where the window changes, as the warp ballot finds
    them), each live sample's terms g * d of that level added to its three
    sums in channel order (f32, one rounding per product and per add, as
    the kernel's `__fmul_rn` / `__fadd_rn`), the group's sums stored, then
    the groups added in order.  Returns (gx, visits [L, M_pad]: how often
    each (level, sample) was taken)."""
    L, C = spec.num_levels, spec.level_dim
    M_pad = xyz4.shape[0]
    NB = M_pad // block
    S, LG = kw.dx_schedule(NB, L, block)
    G = -(-L // LG)
    d = kw.dx_features(xyz4, wob, table, spec, block)  # the kernel's d, bit for bit
    part = torch.full((G, 3, M_pad), float("nan"))
    visits = torch.zeros((L, M_pad), dtype=torch.int64)
    live = xyz4[:, 3] != 0
    for c in range(-(-NB // S)):
        b0 = c * S
        n = min(S, NB - b0)
        for grp in range(G):
            acc = torch.zeros((3, n * block))
            for l in range(grp * LG, min(L, grp * LG + LG)):
                row = wob[l, b0:b0 + n].tolist()
                heads = [r for r in range(n) if r == 0 or row[r] != row[r - 1]]
                for r0, r1 in zip(heads, heads[1:] + [n]):
                    m = slice((b0 + r0) * block, (b0 + r1) * block)
                    a = slice(r0 * block, r1 * block)
                    visits[l, m] += 1
                    for ch in range(C):
                        term = g_sorted[m, l * C + ch] * d[:, l * C + ch, m]
                        acc[:, a] = torch.where(live[m], acc[:, a] + term, acc[:, a])
            part[grp, :, b0 * block:(b0 + n) * block] = acc
    gx = part[0]
    for grp in range(1, G):
        gx = gx + part[grp]
    return gx, visits


@pytest.mark.parametrize("spec_name,input_name",
                         [("small", name) for name in INPUTS]
                         + [("flagship", "uniform"), ("flagship", "crowded")])
def test_input_gradient_schedule_matches_plain(spec_name, input_name):
    """The input-gradient kernel's chunk and level-group walk takes every
    (level, sample) once, writes zeros in the padding slots, and its fixed
    summation order lands within `check_dx`'s reordering bound of
    `window_encode_dx_plain`: 2 (L*C) 2^-24 sum|g * d| per sample and
    dimension."""
    spec, xyz4, wob, g_sorted = _sorted(spec_name, input_name, seed=2)
    block = kw.DEFAULT_BLOCK
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64))
                             .astype(np.float32))
    got, visits = _dx_mirror(xyz4, wob, table, g_sorted, spec, block)
    assert bool((visits == 1).all())
    plain = kw.window_encode_dx_plain(xyz4, wob, table, g_sorted, spec, block)
    d = kw.dx_features(xyz4, wob, table, spec, block)
    tol = 2 * spec.output_dim * 2.0**-24 * (g_sorted.T[None].abs() * d.abs()).sum(1).double()
    assert bool(((got.double() - plain.double()).abs() <= tol).all())
    assert bool((got[:, xyz4[:, 3] == 0] == 0).all()) and float(plain.abs().max()) > 1.0


def test_input_gradient_schedule_from_the_sample_count():
    """(S, LG) from the sample count alone: LG = 2 levels per CUDA block
    (L = 16: eight groups), S = the forward's chunk blocks (~128 chunks) as
    far as the kernel's room for S * block sums allows; for a D-NeRF step's
    M_pad 163,840 (320 blocks of 512) that is 107 chunks of 3 blocks,
    856 CUDA blocks."""
    assert kw.dx_schedule(320, 16, 512) == (3, 2)
    for NB, L, block in [(1, 16, 512), (72, 16, 512), (320, 16, 512), (832, 16, 512),
                         (40, 5, 512), (313, 5, 64), (10_000, 16, 512), (9, 1, 4096)]:
        S, LG = kw.dx_schedule(NB, L, block)
        assert LG == min(2, L) and 1 <= S <= kw.chunk_blocks(NB)
        assert S * block <= kw.DX_MAX_CHUNK_SAMPLES
        assert S == kw.chunk_blocks(NB) or S == kw.DX_MAX_CHUNK_SAMPLES // block
