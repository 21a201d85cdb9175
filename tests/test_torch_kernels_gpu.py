"""The port's CUDA kernels against their plain PyTorch versions, on a card:
bin ranks, the encoder forward, table gradient and input gradient (inside
and outside the unit cube), scatter-add, set-scatter, the hash-product probe, and a small
train step through the kernels against the plain path.

This file imports no JAX, so it runs on a machine with a card and without
JAX:  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
Without a card every test skips (chip_smoke.py holds the same comparisons
at the eval path's full shapes)."""

import numpy as np
import pytest
import torch

from tngp_torch.kernels import scatter as ks
from tngp_torch.kernels import window_encoder as kw
from tngp_torch.ops import window_table as wt

SPEC_KW = dict(num_levels=5, level_dim=2, base_resolution=4, per_level_scale=2.0,
               log2_hashmap_size=15)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M", [37, 5000, 70_000])
def test_bin_ranks_exact(cuda, M):
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.uniform(0, 1, (3, M)).astype(np.float32) ** 3).to(cuda)
    keyp = kw._padded_keys(wt.sample_tiles(x))
    for a, b in zip(kw.bin_ranks(keyp), kw.bin_ranks_plain(keyp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(kw.bin_dest(x), kw.bin_dest_ref(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_window_encoder_matches_plain(cuda, interpolation):
    """f32 corner-sum order: below 2 * 7 * 2^-24 * 5 for N(0,1) tables."""
    spec = wt.WindowSpec.create(**SPEC_KW, interpolation=interpolation)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 5000)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(
        rng.normal(size=(spec.total_rows, spec.level_dim)).astype(np.float32)).to(cuda)
    win = wt.window_view(table, spec).contiguous()
    got = kw.window_encode_binned(x, win, spec)
    want = wt.window_encode_ref(x, table, spec, emulate_bf16=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=5e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("crowd", [False, True])
def test_window_encoder_backward_matches_plain(cuda, interpolation, crowd):
    """The backward kernel through autograd against its sorted plain version
    and the canonical-layout oracle: the same bf16-rounded terms, summed by
    atomics in another order.  Any order of an entry's n terms is within
    (n - 1) 2^-24 sum|term| of the exact sum, so two orders are within twice
    that; n is counted per entry, so an entry with one term must be exact
    (which pins the single bf16 rounding of w * g) and an entry with two is
    held to one f32 ulp of its terms.  `crowd` puts every sample in one tile."""
    spec = wt.WindowSpec.create(**SPEC_KW, interpolation=interpolation)
    L, C = spec.num_levels, spec.level_dim
    rng = np.random.default_rng(5)
    M = 20_000
    x = torch.from_numpy(rng.uniform(0, 1, (3, M)).astype(np.float32)).to(cuda)
    if crowd:
        x = x * 0.24
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    win = torch.from_numpy(rng.normal(
        size=(spec.n_windows, C, 128, 64)).astype(np.float32)).to(cuda)
    win.requires_grad_(True)
    (kw.window_encode_binned(x, win, spec) * g.T.contiguous().T).sum().backward()
    got = win.grad
    dest, tob = kw.bin_dest(x)
    M_pad = kw.padded_size(M, kw.DEFAULT_BLOCK)
    payload = torch.cat([x, torch.ones((1, M), device=cuda)]).T.contiguous()
    xyz4 = ks.scatter_add(dest, payload, M_pad, indices="unique")
    g_sorted = ks.scatter_add(dest, g.T.contiguous(), M_pad, indices="unique")
    wob = kw._wob_local(spec, tob)
    plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, kw.DEFAULT_BLOCK)
    sabs = kw.window_encode_bwd_plain(xyz4, wob, g_sorted.abs(), spec, kw.DEFAULT_BLOCK)
    oracle = wt.window_view(wt.window_table_grad_ref(x, g, spec, emulate_bf16=True), spec)
    # terms per entry, counted at channel 0's addresses (every channel takes the same)
    addr = torch.stack([kw.sorted_corner_addresses(xyz4, wob, spec, kw.DEFAULT_BLOCK, l)[0]
                        for l in range(L)])
    live = (xyz4[:, 3] > 0).expand(L, 8, -1).reshape(-1).float()
    n = torch.zeros(got.numel(), device=cuda).index_add_(0, addr.reshape(-1), live)
    n = n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(got.shape)
    assert float(n.min()) == 0 and float(n.max()) > 8 and (crowd or bool((n == 1).any()))
    tol = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double()
    assert bool(((got.double() - plain.double()).abs() <= tol).all())
    assert bool(((got.double() - oracle.double()).abs() <= tol).all())
    assert bool(((got == 0) == (plain == 0)).all()) and float(got.abs().max()) > 0.1


def _sorted_inputs(x, g, spec, cuda):
    """(xyz4, wob, dest, g_sorted) as `window_encode_binned` makes them."""
    M = x.shape[1]
    dest, tob = kw.bin_dest(x)
    M_pad = kw.padded_size(M, kw.DEFAULT_BLOCK)
    payload = torch.cat([x, torch.ones((1, M), device=cuda)]).T.contiguous()
    return (ks.scatter_add(dest, payload, M_pad, indices="unique"), kw._wob_local(spec, tob),
            dest, ks.scatter_add(dest, g.T.contiguous(), M_pad, indices="unique"))


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.06, 1.06)])
def test_input_gradient_kernel_matches_plain(cuda, interpolation, lo, hi):
    """Through autograd (`input_grads=True`) against the plain version on
    the same sorted inputs.  Both form the same L*C f32 products g * d per
    sample and dimension (d bit for bit: the same bf16 roundings, corners
    summed in order); the kernel adds them in (level, channel) order, the
    plain version in torch's, so each entry is within 2 (L*C) 2^-24
    sum|g * d|.  x01 in [-0.06, 1.06] puts dense corners outside the window."""
    spec = wt.WindowSpec.create(**SPEC_KW, interpolation=interpolation)
    rng = np.random.default_rng(7)
    M = 20_000
    x = torch.from_numpy(rng.uniform(lo, hi, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    win = torch.from_numpy(rng.normal(
        size=(spec.n_windows, spec.level_dim, 128, 64)).astype(np.float32)).to(cuda)
    xg = x.clone().requires_grad_(True)
    (kw.window_encode_binned(xg, win, spec, input_grads=True) * g).sum().backward()
    xyz4, wob, dest, g_sorted = _sorted_inputs(x, g, spec, cuda)
    plain = kw.window_encode_dx_plain(xyz4, wob, win, g_sorted, spec, kw.DEFAULT_BLOCK)
    d = kw.dx_features(xyz4, wob, win, spec, kw.DEFAULT_BLOCK)
    sabs = (g_sorted.T[None].abs() * d.abs()).sum(1)
    tol = 2 * spec.output_dim * 2.0**-24 * sabs.double()
    err = (xg.grad.double() - plain[:, dest].double()).abs()
    assert bool((err <= tol[:, dest]).all()), float(err.max())
    assert float(plain.abs().max()) > 1.0
    # padding slots of the kernel's sorted output are zero
    gx_sorted = kw.window_encode_dx(xyz4, wob, win, g_sorted, spec, kw.DEFAULT_BLOCK)
    pad = xyz4[:, 3] == 0
    assert bool(pad.any()) and bool((gx_sorted[:, pad] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_out_of_range_samples_forward_and_backward_match_plain(cuda, interpolation):
    """Samples with x01 in [-0.06, 1.06]: dense corners outside the window
    contribute nothing in the kernels as in the plain versions (forward to
    the corner-sum order, the table gradient to twice the reordering bound;
    the canonical oracle too, which applies the same rule)."""
    spec = wt.WindowSpec.create(**SPEC_KW, interpolation=interpolation)
    rng = np.random.default_rng(11)
    M = 20_000
    x = torch.from_numpy(rng.uniform(-0.06, 1.06, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(
        rng.normal(size=(spec.total_rows, spec.level_dim)).astype(np.float32)).to(cuda)
    win = wt.window_view(table, spec).contiguous().requires_grad_(True)
    out = kw.window_encode_binned(x, win, spec)
    want = wt.window_encode_ref(x, table, spec, emulate_bf16=True)
    torch.testing.assert_close(out.detach(), want, rtol=1e-5, atol=5e-6)
    (out * g).sum().backward()
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, kw.DEFAULT_BLOCK)
    sabs = kw.window_encode_bwd_plain(xyz4, wob, g_sorted.abs(), spec, kw.DEFAULT_BLOCK)
    n = torch.zeros(plain.numel(), device=cuda)
    for l in range(spec.num_levels):
        addr = kw.sorted_corner_addresses(xyz4, wob, spec, kw.DEFAULT_BLOCK, l)[0]
        n.index_add_(0, addr.reshape(-1), (xyz4[:, 3] > 0).expand(8, -1).reshape(-1).float())
    n = n.reshape(spec.n_windows, spec.level_dim, -1)[:, :1].expand(
        -1, spec.level_dim, -1).reshape(plain.shape)
    tol = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double()
    assert bool(((win.grad.double() - plain.double()).abs() <= tol).all())


@pytest.mark.gpu
def test_int_mul_probe_exact(cuda):
    from tngp_torch.kernels.int_mul import int_mul_hash, int_mul_hash_plain

    x = torch.arange(1 << 13, dtype=torch.int32, device=cuda).reshape(8, -1)
    x = torch.cat([x, torch.tensor([[-1, -5000, 2**31 - 1, -(2**31)] * 256],
                                   dtype=torch.int32, device=cuda)])
    assert torch.equal(int_mul_hash(x), int_mul_hash_plain(x))


@pytest.mark.gpu
def test_train_step_gradients_through_kernels_match_plain_path(cuda):
    """One small training render + backward through the kernels and inside
    `plain_versions()`: same loss to 1e-5, every gradient to 1e-3 of its
    norm (f32 MLPs; only summation order differs)."""
    from tngp_torch.data import make_blob_field, orbit_poses, sample_rays
    from tngp_torch.kernels import plain_versions
    from tngp_torch.models import NGPNetwork
    from tngp_torch.ops.grid_utils import packbits
    from tngp_torch.render import FieldFns, RenderConfig, cell_centers_cf, render_rays_train

    cfg = RenderConfig(bound=1.0, grid_size=32, max_steps=64, K=16, min_near=0.05,
                       compact_fraction=0.25, density_thresh=1.0, march_dense=True)
    model = NGPNetwork(num_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12,
                       device=cuda)
    with torch.no_grad():
        model.encoder.embeddings.normal_(0, 0.3)
    dens = make_blob_field(0, device=cuda).density(None, cell_centers_cf(0, 1.0, 32, cuda))
    bitfield = packbits(dens, 1.0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    intr = torch.tensor([28.8, 28.8, 16.0, 16.0], device=cuda)
    r = sample_rays(torch.from_numpy(orbit_poses(4)[1]).to(cuda), intr, 32, 32, 512,
                    generator=gen)
    noise = torch.rand(512, generator=gen, device=cuda)

    def grads():
        model.zero_grad(set_to_none=True)
        out = render_rays_train(FieldFns.from_model(model), None, r["rays_o"], r["rays_d"],
                                bitfield, cfg, noise=noise)
        loss = ((out["image"] - 0.5) ** 2).mean()
        loss.backward()
        return float(loss), [p.grad.clone() for p in model.parameters()]

    loss_k, g_k = grads()
    with plain_versions():
        loss_p, g_p = grads()
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for a, b in zip(g_k, g_p):
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()) and float(b.norm()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("indices,C", [("unique", 4), ("unique", 32), ("unique", 5),
                                       ("sorted", 5), ("sorted", 6), ("sorted", 32),
                                       ("any", 4), ("any", 5), ("any", 6)])
def test_scatter_add_matches_plain(cuda, indices, C):
    """Each form on indices that hold its statement.  Unique: exact against
    the plain version.  Sorted and any: each row within (n - 1) 2^-24
    sum|v| of the exact (f64) sum, n = the row's entry count (any order of
    n f32 terms is), and within rtol 1e-5, atol 1e-4 of the plain version;
    sorted also bitwise the same on a second call.  A tail of out-of-range
    rows (the compositor's padding) is dropped.  The same values at an odd
    offset (not 16-byte aligned) take the scalar path and give the same."""
    rng = np.random.default_rng(C)
    M, rows = 100_000, 512
    vals = torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32)).to(cuda)
    if indices == "unique":
        rows = 131_072
        idx = torch.from_numpy(rng.permutation(rows)[:M]).to(cuda)
    else:
        idx = torch.sort(torch.from_numpy(rng.integers(0, rows, M))).values.to(cuda)
        idx[-M // 8:] = rows
        if indices == "any":
            idx = idx[torch.from_numpy(rng.permutation(M)).to(cuda)]
    want = ks.scatter_add_plain(idx, vals, rows)
    slot = torch.where(idx < rows, idx, rows)
    exact = torch.zeros((rows + 1, C), dtype=torch.float64, device=cuda).index_add_(
        0, slot, vals.double())[:rows]
    sabs = torch.zeros((rows + 1, C), dtype=torch.float64, device=cuda).index_add_(
        0, slot, vals.double().abs())[:rows]
    n = torch.bincount(slot, minlength=rows + 1)[:rows].double()[:, None]
    tol = (n - 1).clamp(min=0) * 2.0**-24 * sabs

    def check(got):
        assert got.shape == (rows, C)
        if indices == "unique":
            assert torch.equal(got, want)
        else:
            assert bool(((got.double() - exact).abs() <= tol).all())
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

    got = ks.scatter_add(idx, vals, rows, indices=indices)
    check(got)
    if indices == "sorted":
        assert torch.equal(got, ks.scatter_add(idx, vals, rows, indices=indices))
    flat = torch.empty(M * C + 1, device=cuda)
    flat[1:] = vals.reshape(-1)
    check(ks.scatter_add(idx, flat[1:].view(M, C), rows, indices=indices))


@pytest.mark.gpu
def test_scatter_kernels_replay_in_a_cuda_graph(cuda):
    """`kernel_times.graph_replay_ms`, the device timing used where the
    profiler records nothing, captures each scatter-add form and the
    cooperative set-scatter: a replay leaves the direct call's output
    (bitwise for unique, sorted and the set; within f32 reordering for the
    atomic form)."""
    from tngp_torch.diagnostics.kernel_times import graph_replay_ms

    rng = np.random.default_rng(3)
    M, rows = 50_000, 1024
    vals = torch.from_numpy(rng.normal(size=(M, 4)).astype(np.float32)).to(cuda)
    sorted_idx = torch.sort(torch.from_numpy(rng.integers(0, rows, M))).values.to(cuda)
    vals0 = vals[:, 0].contiguous()
    calls = {
        "unique": lambda: ks.scatter_add(torch.arange(M, device=cuda), vals, M,
                                         indices="unique"),
        "sorted": lambda: ks.scatter_add(sorted_idx, vals, rows, indices="sorted"),
        "any": lambda: ks.scatter_add(sorted_idx, vals, rows, indices="any"),
        "set": lambda: ks.scatter_set_flat(sorted_idx, vals0, 4096),
    }
    for name, call in calls.items():
        out = {}

        def fn():
            out["y"] = call()

        assert graph_replay_ms(fn) > 0
        want = call()
        if name == "any":
            torch.testing.assert_close(out["y"], want, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(out["y"], want), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["duplicates", "ragged_with_skips", "all_skip", "empty"])
def test_scatter_set_matches_plain_exactly(cuda, case):
    """Exact and deterministic: the last write wins a repeated cell, -1
    skips, M = 0 gives all `init`; int32 indices are refused."""
    rng = np.random.default_rng(2)
    cells = 4096
    M = {"duplicates": 200_000, "ragged_with_skips": 70_001, "all_skip": 5000, "empty": 0}[case]
    idx = rng.integers(0, cells, M)
    if case == "ragged_with_skips":
        idx[rng.random(M) < 0.2] = -1
    if case == "all_skip":
        idx[:] = -1
    vals = rng.normal(size=M).astype(np.float32)
    init = 0.5 if case == "ragged_with_skips" else -1.0
    idx_t, vals_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    got = ks.scatter_set_flat(idx_t, vals_t, cells, init)
    torch.cuda.synchronize()
    assert torch.equal(got, ks.scatter_set_flat_plain(idx_t, vals_t, cells, init))
    assert torch.equal(got, ks.scatter_set_flat(idx_t, vals_t, cells, init))
    last = np.full(cells, init, np.float32)
    keep = idx >= 0
    # the first occurrence in the reversed writes is the last write of a cell
    c, first = np.unique(idx[keep][::-1], return_index=True)
    last[c] = vals[keep][::-1][first]
    np.testing.assert_array_equal(got.cpu().numpy(), last)
    with pytest.raises(TypeError):
        ks.scatter_set_flat(idx_t.int(), vals_t, cells)


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ks.scatter_add(idx, torch.zeros(4, 2, device=cuda), 3)
    with pytest.raises(ValueError):
        ks.scatter_add(idx.long(), torch.zeros(2, 4, device=cuda).T, 3)


FLAGSHIP = dict(desired_resolution=2048)
# name -> (M, x01 from uniform [0, 1] draws u): the small eval bucket (a
# 4096-sample query, 36,864 padded slots: mostly padding), every sample in
# one tile, and the top training tier's width
PATH_INPUTS = {
    "small_bucket": (4096, lambda u: u),
    "crowded": (131_072, lambda u: u * 0.24),
    "uniform": (131_072, lambda u: u),
}


def _bwd_within_reordering_bound(got, xyz4, wob, g_sorted, spec):
    """Each entry within 2 (n - 1) 2^-24 sum|term| of the plain version (n
    terms per entry, counted at channel 0's addresses) and the same zeros."""
    block = kw.DEFAULT_BLOCK
    plain = kw.window_encode_bwd_plain(xyz4, wob, g_sorted, spec, block)
    sabs = kw.window_encode_bwd_plain(xyz4, wob, g_sorted.abs(), spec, block)
    live = (xyz4[:, 3] > 0).expand(8, -1).reshape(-1).float()
    n = torch.zeros(plain.numel(), device=plain.device)
    for l in range(spec.num_levels):
        addr = kw.sorted_corner_addresses(xyz4, wob, spec, block, l)[0]
        n.index_add_(0, addr.reshape(-1), live)
    C = spec.level_dim
    n = n.reshape(spec.n_windows, C, -1)[:, :1].expand(-1, C, -1).reshape(plain.shape)
    tol = 2.0 * torch.clamp(n - 1, min=0).double() * 2.0**-24 * sabs.double()
    return (bool(((got.double() - plain.double()).abs() <= tol).all())
            and bool(((got == 0) == (plain == 0)).all()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PATH_INPUTS))
def test_encoder_kernels_at_the_flagship_widths(cuda, case):
    """The flagship spec (749 windows): the forward to 6e-6 of its plain
    version (corner sums of bf16-exact products for N(0, 1) table values,
    as chip_smoke.py), the table gradient to the reordering bound with the
    plain version's zeros, on a mostly-padding small bucket, on samples all
    in one tile (one window per level takes every sample) and uniform."""
    spec = wt.WindowSpec.create(**FLAGSHIP)
    M, make = PATH_INPUTS[case]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(make(rng.uniform(0, 1, (3, M))).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    block = kw.DEFAULT_BLOCK
    got = kw.window_encode_fwd(xyz4, wob, table, spec, block)
    want = kw.window_encode_fwd_plain(xyz4, wob, table, spec, block)
    assert float((got - want).abs().max()) <= 6e-6
    assert bool((got[:, xyz4[:, 3] == 0] == 0).all())
    gtab = kw.window_encode_bwd(xyz4, wob, g_sorted, spec, block)
    assert _bwd_within_reordering_bound(gtab, xyz4, wob, g_sorted, spec)


@pytest.mark.gpu
def test_encoder_kernels_with_no_samples(cuda):
    """M = 0 through autograd (every slot padding: zero features, a zero
    gradient) and M_pad = 0 straight to the kernels (the gradient is still
    written: all zeros)."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    win = spec.init_table_win(device=cuda).requires_grad_(True)
    x = torch.zeros((3, 0), device=cuda)
    out = kw.window_encode_binned(x, win, spec)
    assert out.shape == (spec.output_dim, 0)
    out.sum().backward()
    assert bool((win.grad == 0).all())
    xyz4 = torch.zeros((0, 4), device=cuda)
    wob = torch.zeros((spec.num_levels, 0), dtype=torch.int32, device=cuda)
    g0 = torch.zeros((0, spec.output_dim), device=cuda)
    assert kw.window_encode_fwd(xyz4, wob, win.detach(), spec, kw.DEFAULT_BLOCK).shape == (
        spec.output_dim, 0)
    gtab = kw.window_encode_bwd(xyz4, wob, g0, spec, kw.DEFAULT_BLOCK)
    assert bool((gtab == 0).all())


@pytest.mark.gpu
def test_encoder_kernels_replay_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph (`kernel_times.graph_replay_ms`), the
    forward replays to the direct call's bits and the table gradient to
    within the reordering bound of the plain version."""
    from tngp_torch.diagnostics.kernel_times import graph_replay_ms

    spec = wt.WindowSpec.create(**FLAGSHIP)
    rng = np.random.default_rng(17)
    M = 20_000
    x = torch.from_numpy(rng.uniform(0, 1, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    out = {}

    def fwd():
        out["f"] = kw.window_encode_fwd(xyz4, wob, table, spec, kw.DEFAULT_BLOCK)

    def bwd():
        out["b"] = kw.window_encode_bwd(xyz4, wob, g_sorted, spec, kw.DEFAULT_BLOCK)

    assert graph_replay_ms(fwd) > 0 and graph_replay_ms(bwd) > 0
    assert torch.equal(out["f"], kw.window_encode_fwd(xyz4, wob, table, spec, kw.DEFAULT_BLOCK))
    assert _bwd_within_reordering_bound(out["b"], xyz4, wob, g_sorted, spec)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 4, 8])
def test_encoder_kernels_other_channel_counts(cuda, C):
    """C = 1, 4, 8: the forward stages (C + 1) / 2 planes of bf16 pairs
    (128 KB for C = 8), the table gradient accumulates two channels per
    pass; both against their plain versions as above.  C = 3 is refused."""
    spec = wt.WindowSpec.create(**{**SPEC_KW, "level_dim": C})
    rng = np.random.default_rng(C)
    M = 20_000
    x = torch.from_numpy(rng.uniform(-0.06, 1.06, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, C, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    got = kw.window_encode_fwd(xyz4, wob, table, spec, kw.DEFAULT_BLOCK)
    want = kw.window_encode_fwd_plain(xyz4, wob, table, spec, kw.DEFAULT_BLOCK)
    assert float((got - want).abs().max()) <= 6e-6
    gtab = kw.window_encode_bwd(xyz4, wob, g_sorted, spec, kw.DEFAULT_BLOCK)
    assert _bwd_within_reordering_bound(gtab, xyz4, wob, g_sorted, spec)
    spec3 = wt.WindowSpec.create(**{**SPEC_KW, "level_dim": 3})
    with pytest.raises(ValueError):
        kw.window_encode_fwd(xyz4, wob, torch.zeros((spec3.n_windows, 3, 128, 64),
                                                    device=cuda), spec3, kw.DEFAULT_BLOCK)
    with pytest.raises(ValueError):  # not 16-byte aligned
        flat = torch.zeros(table.numel() + 1, device=cuda)
        kw.window_encode_fwd(xyz4, wob, flat[1:].view(table.shape), spec, kw.DEFAULT_BLOCK)


@pytest.mark.gpu
def test_encoder_kernels_take_unaligned_scalar_inputs(cuda):
    """Only xyz4 and the forward's table are read with 16-byte loads: the
    table gradient's cotangents and the input gradient's table and
    cotangents at an odd offset are taken, and give what aligned copies
    give (the gradient within the reordering bound, gx bitwise)."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    rng = np.random.default_rng(23)
    M = 20_000
    x = torch.from_numpy(rng.uniform(-0.06, 1.06, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)

    def odd(t):
        flat = torch.empty(t.numel() + 1, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    g_odd, table_odd = odd(g_sorted), odd(table)
    assert g_odd.data_ptr() % 16 and table_odd.data_ptr() % 16
    gtab = kw.window_encode_bwd(xyz4, wob, g_odd, spec, kw.DEFAULT_BLOCK)
    assert _bwd_within_reordering_bound(gtab, xyz4, wob, g_sorted, spec)
    assert torch.equal(kw.window_encode_dx(xyz4, wob, table_odd, g_odd, spec, kw.DEFAULT_BLOCK),
                       kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, kw.DEFAULT_BLOCK))
    with pytest.raises(ValueError):  # the forward stages the table with 16-byte loads
        kw.window_encode_fwd(xyz4, wob, table_odd, spec, kw.DEFAULT_BLOCK)
