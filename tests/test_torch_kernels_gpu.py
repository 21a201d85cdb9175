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
    """The bin sort's first stage (ranks and histograms per key block,
    which `bin_dest_stages` hands back) exactly as `bin_ranks_plain`, and
    its destinations and block tiles exactly as the plain `bin_dest`."""
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.uniform(0, 1, (3, M)).astype(np.float32) ** 3).to(cuda)
    keyp = kw._padded_keys(wt.sample_tiles(x))
    dest, tob, rank, tot = kw.bin_dest_stages(x)
    for a, b in zip((rank, tot), kw.bin_ranks_plain(keyp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip((dest, tob), kw.bin_dest_ref(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bin_inputs(case, M, cuda):
    rng = np.random.default_rng(M + 1)
    x = rng.uniform(0, 1, (3, M)).astype(np.float32)
    if case == "one_tile":
        x *= 0.24
    elif case == "nan_inf":
        x[0, ::7], x[1, 1::5], x[2, 2::9] = np.nan, np.inf, -np.inf
    return torch.from_numpy(x).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case,M", [("uniform", M) for M in (1, 511, 512, 4096, 393_216)]
                         + [("one_tile", 70_000), ("nan_inf", 70_000), ("uniform", 0)])
@pytest.mark.parametrize("block", [512, 64])
def test_bin_dest_exact(cuda, case, M, block):
    """dest and tob exactly as the plain `bin_dest`, at sample counts around
    the 512-key blocks up to the eval's top width, every sample in one tile,
    NaN and infinite coordinates, no samples, and x01 as a strided view."""
    x = _bin_inputs(case, M, cuda)
    for a, b in zip(kw.bin_dest(x, block), kw.bin_dest_ref(x, block)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    strided = torch.empty((M, 5), device=cuda)
    strided[:, 1:4] = x.T
    for a, b in zip(kw.bin_dest(strided[:, 1:4].T, block), kw.bin_dest_ref(x, block)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.gpu
def test_bin_dest_is_at_most_three_device_operations(cuda):
    """One call: the rank, scan and destination kernels and nothing else on
    the device (the profiler's device events per call)."""
    from tngp_torch.diagnostics.kernel_times import device_ms

    x = _bin_inputs("uniform", 393_216, cuda)
    _, events, method = device_ms(lambda: kw.bin_dest(x))
    assert method == "profiler" and events <= 3


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
    model = NGPNetwork(encoding="hashgrid_window",
                       num_levels=4, hidden_dim=16, hidden_dim_color=16, log2_hashmap_size=12,
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
@pytest.mark.parametrize("C", [16, 48, 64])
def test_scatter_add_any_at_a_line_gradient_shape(cuda, C):
    """The general form where TensoRF's and CCNeRF's line gradients put it:
    the two corners of 131,072 samples into a line of 128 rows, about 2,048
    adds a row (C = 16 and 48: TensoRF VM's sigma and colour ranks, 64:
    CCNeRF's vector groups), and a line whose slots mostly sit at one
    position (CCNeRF's masked samples at 0: rows 63 and 64 take most
    adds).  Each row within (n - 1) 2^-24 sum|v| of the exact (f64) sum;
    a line gradient through `grid_sample_1d_cf_vjp` equals the scatter of
    its own corners within the same bound."""
    from tngp_torch.ops import grid_sample as gs

    rng = np.random.default_rng(C)
    B, D = 131_072, 128
    w = torch.from_numpy(rng.uniform(-1, 1, B).astype(np.float32)).to(cuda)
    w[: B // 2] = 0.0  # masked slots at position 0
    g = torch.from_numpy(rng.normal(size=(C, B)).astype(np.float32)).to(cuda)
    corners = gs._corners_1d(D, w, False)
    idx = torch.cat([c[0] for c in corners])
    vals = torch.cat([(g * c[1][None]).T for c in corners]).contiguous()
    exact = torch.zeros((D, C), dtype=torch.float64, device=cuda).index_add_(0, idx,
                                                                           vals.double())
    sabs = torch.zeros((D, C), dtype=torch.float64, device=cuda).index_add_(
        0, idx, vals.double().abs())
    n = torch.bincount(idx, minlength=D).double()[:, None]
    tol = (n - 1).clamp(min=0) * 2.0**-24 * sabs
    assert int(n.max()) > B // 2  # the centre rows' contention
    got = ks.scatter_add(idx, vals, D, indices="any")
    assert bool(((got.double() - exact).abs() <= tol).all())
    line = torch.zeros((C, D), device=cuda, requires_grad=True)
    gs.grid_sample_1d_cf_vjp(line, w, align_corners=False).backward(g)
    assert bool(((line.grad.T.double() - exact).abs() <= tol).all())


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


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("crowd", [False, True])
def test_input_gradient_kernel_channels_and_one_tile(cuda, interpolation, C, crowd):
    """The input gradient within `check_dx`'s reordering bound of its plain
    version (2 (L*C) 2^-24 sum|g * d| per sample and dimension), zero in
    every padding slot and bitwise the same on a second call, for each
    channel count, both interpolations, and every sample in one tile."""
    spec = wt.WindowSpec.create(**{**SPEC_KW, "level_dim": C}, interpolation=interpolation)
    rng = np.random.default_rng(29 + C)
    M = 20_000
    x = rng.uniform(-0.06, 1.06, (3, M)).astype(np.float32) * (0.24 if crowd else 1.0)
    x = torch.from_numpy(x).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, C, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    block = kw.DEFAULT_BLOCK
    got = kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block)
    plain = kw.window_encode_dx_plain(xyz4, wob, table, g_sorted, spec, block)
    d = kw.dx_features(xyz4, wob, table, spec, block)
    tol = 2 * spec.output_dim * 2.0**-24 * (g_sorted.T[None].abs() * d.abs()).sum(1).double()
    assert bool(((got.double() - plain.double()).abs() <= tol).all())
    assert bool((got[:, xyz4[:, 3] == 0] == 0).all()) and float(plain.abs().max()) > 1.0
    assert torch.equal(got, kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, block))


@pytest.mark.gpu
def test_input_gradient_kernel_with_no_samples_and_in_a_cuda_graph(cuda):
    """M_pad = 0 gives an empty gx; captured in a CUDA graph, the flagship
    input gradient replays to the direct call's bits."""
    from tngp_torch.diagnostics.kernel_times import graph_replay_ms

    spec = wt.WindowSpec.create(**FLAGSHIP)
    table = torch.zeros((spec.n_windows, spec.level_dim, 128, 64), device=cuda)
    gx = kw.window_encode_dx(torch.zeros((0, 4), device=cuda),
                             torch.zeros((spec.num_levels, 0), dtype=torch.int32, device=cuda),
                             table, torch.zeros((0, spec.output_dim), device=cuda), spec,
                             kw.DEFAULT_BLOCK)
    assert gx.shape == (3, 0)
    rng = np.random.default_rng(31)
    M = 20_000
    x = torch.from_numpy(rng.uniform(0, 1, (3, M)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(spec.output_dim, M)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64))
                             .astype(np.float32)).to(cuda)
    xyz4, wob, _, g_sorted = _sorted_inputs(x, g, spec, cuda)
    out = {}

    def dx():
        out["x"] = kw.window_encode_dx(xyz4, wob, table, g_sorted, spec, kw.DEFAULT_BLOCK)

    assert graph_replay_ms(dx) > 0
    assert torch.equal(out["x"], kw.window_encode_dx(xyz4, wob, table, g_sorted, spec,
                                                     kw.DEFAULT_BLOCK))


def _reordering_bound_holds(got, idx, vals, rows):
    """Each entry of `got` within (n - 1) 2^-24 sum|v| of the exact (f64)
    sum of its terms, n the nonzero ones (adding a zero rounds nothing)."""
    C = vals.shape[1]

    def f64_sum(v):
        return torch.zeros((rows, C), dtype=torch.float64, device=vals.device).index_add_(
            0, idx, v.double())

    exact, sabs, n = f64_sum(vals), f64_sum(vals.abs()), f64_sum(vals != 0)
    return bool(((got.double() - exact).abs() <= (n - 1).clamp(min=0) * 2.0**-24 * sabs).all())


@pytest.mark.gpu
def test_hash_grid_vjp_matches_plain(cuda):
    """The golden grid's encode and backward on the card (a 3-D tiled spec
    of 4 levels, x01 in [-0.06, 1.06]) against the same inside
    `plain_versions()`: the forward and the input gradient are the same
    torch ops in both (equal to 1e-6); the table gradient goes through
    `scatter_add_any` once per level, within the f32 reordering bound of
    the exact sum, and matches the plain one to rtol 1e-5, atol 1e-6."""
    from tngp_torch import kernels
    from tngp_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec.create(num_levels=4, log2_hashmap_size=12, desired_resolution=256,
                                  gridtype="tiled")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.06, 1.06, (3, 20_000)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.normal(size=(spec.total_params, 2)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(8, 20_000)).astype(np.float32)).to(cuda)

    def run():
        xt, tt = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
        out = hg.hash_encode_cf_vjp(xt, tt, spec)
        (out * g).sum().backward()
        return out.detach(), xt.grad, tt.grad

    kernels.reset_launch_counts()
    out_k, gx_k, gt_k = run()
    assert kernels.KERNELS["scatter_add_any"].launches == spec.num_levels
    with kernels.plain_versions():
        out_p, gx_p, gt_p = run()
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(gx_k, gx_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gt_k, gt_p, rtol=1e-5, atol=1e-6)
    oob = ((x < 0) | (x > 1)).any(dim=0)
    assert not bool(gx_k[:, oob].any())


@pytest.mark.gpu
def test_scatter_add_any_at_level_zero_contention(cuda):
    """The table gradient's coarsest level at a training step's width: 8
    corners x 131,072 samples into the 4,920 rows of level 0 of the default
    spec (~213 adds a row), C = 2, within the reordering bound."""
    from tngp_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec.create(desired_resolution=2048, gridtype="tiled")
    rows = spec.offsets[1]
    assert rows == 4920
    x = torch.rand((3, 131_072), generator=torch.Generator(device=cuda).manual_seed(0),
                   device=cuda)
    idx, w, _, _ = hg._level_geometry(spec, 0, x)
    vals = (w[:, :, None] * torch.randn((1, 131_072, 2), device=cuda)).reshape(-1, 2)
    idx = idx.reshape(-1)
    got = ks.scatter_add(idx, vals, rows, indices="any")
    assert _reordering_bound_holds(got, idx, vals, rows)
    torch.testing.assert_close(got, ks.scatter_add_plain(idx, vals, rows), rtol=1e-4, atol=1e-4)


def _any_case(case, cuda):
    """(idx, vals, rows) of one case of the any form's designs."""
    g = torch.Generator().manual_seed(7)

    def rand(n, C, rows):
        return torch.randint(0, rows, (n,), generator=g), torch.randn((n, C), generator=g)

    if case in ("budget_under", "budget_over"):
        rows = ks.SMEM_BUDGET // 8 + (case == "budget_over")
        idx, vals = rand(1_048_576, 2, rows)
    elif case == "hot_row_and_zero_rows":  # CCNeRF's line: a centre row, zero cotangents
        rows, n = 128, 1_048_576
        idx, vals = rand(n, 64, rows)
        idx[torch.randperm(n, generator=g)[:219_096]] = 63
        zero = torch.randperm(n, generator=g)[: n // 5]
        vals[zero] = 0.0
        vals[zero[::2]] = -0.0
    elif case == "out_of_range":
        rows = 500
        idx, vals = rand(300_000, 16, rows)
        idx[::7], idx[3::11], idx[5::13], idx[6::17] = -1, -(2**40), rows, 2**40
    elif case == "n0":
        rows, idx, vals = 300, torch.zeros(0, dtype=torch.int64), torch.zeros((0, 8))
    elif case in ("C1", "C3"):
        rows = 2000
        idx, vals = rand(400_000, int(case[1]), rows)
    elif case in ("exact_hot_row_C64", "exact_hot_row_runs_C2"):
        # integer values in [-4, 4] on a row of 219,096 adds: every partial
        # sum is exact in f32, so a lost or repeated add shows as a
        # difference from the plain version, where the reordering bound is
        # too loose to see it; at C = 2 the rows come in runs
        n, C = 1_048_576, int(case.rsplit("C", 1)[1])
        rows = 128 if C == 64 else 4920
        if C == 2:
            idx = torch.repeat_interleave(torch.randint(0, rows, (n // 4,), generator=g),
                                          torch.randint(1, 30, (n // 4,), generator=g))[:n]
        else:
            idx = torch.randint(0, rows, (n,), generator=g)
        idx[torch.randperm(n, generator=g)[:219_096]] = 63
        vals = torch.randint(-4, 5, (n, C), generator=g).float()
        zero = torch.randperm(n, generator=g)[: n // 5]
        vals[zero] = 0.0
        vals[zero[::2]] = -0.0
    elif case == "level0_runs":  # consecutive entries share rows, as ray samples share cells
        rows = 4920
        idx = torch.repeat_interleave(torch.randint(0, rows, (1 << 16,), generator=g),
                                      torch.randint(1, 30, (1 << 16,), generator=g))
        vals = torch.randn((idx.numel(), 2), generator=g)
    else:  # "unaligned_C4": vals 4 bytes past a 16-byte boundary
        rows = 1000
        idx = torch.randint(0, rows, (300_001,), generator=g)
        flat = torch.randn(300_001 * 4 + 1, generator=g).to(cuda)
        return idx.to(cuda), flat[1:].view(300_001, 4), rows
    return idx.to(cuda), vals.to(cuda), rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["budget_under", "budget_over", "hot_row_and_zero_rows",
                                  "out_of_range", "n0", "C1", "C3", "level0_runs",
                                  "unaligned_C4", "exact_hot_row_C64",
                                  "exact_hot_row_runs_C2"])
def test_scatter_add_any_designs_match_plain(cuda, case):
    """Every design of the any form that can take the case (`any_form` with
    `form=`), and the one the dispatch picks, within (n - 1) 2^-24 sum|v| of
    the exact (f64) sum of each entry, n its nonzero terms; on the "exact"
    cases' integer values bitwise equal to the plain version; no -0.0; the
    owner design bitwise the same on a second call; the design counted under
    `forms`."""
    from tngp_torch import kernels

    idx, vals, rows = _any_case(case, cuda)
    designs = ks.any_designs(*vals.shape, rows)
    assert "rows" in designs and "warp" in designs
    kernels.reset_launch_counts()
    for form in designs + [None]:
        got = (ks.scatter_add(idx, vals, rows, indices="any") if form is None
               else ks.scatter_add_any_as(idx, vals, rows, form))
        torch.cuda.synchronize()
        ok = (idx >= 0) & (idx < rows)
        assert got.shape == (rows, vals.shape[1])
        assert _reordering_bound_holds(got, idx[ok], vals[ok], rows), form
        assert not bool(((got == 0) & torch.signbit(got)).any()), form
        if case.startswith("exact"):
            assert torch.equal(got, ks.scatter_add_plain(idx, vals, rows)), form
        if (form or ks.any_form(*vals.shape, rows).form) == "owner":
            assert torch.equal(got, ks.scatter_add_any_as(idx, vals, rows, "owner"))
    info = kernels.KERNELS["scatter_add_any"]
    assert info.launches == sum(info.forms.values()) >= len(designs) + 1

