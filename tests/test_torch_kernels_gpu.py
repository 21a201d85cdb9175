"""The port's CUDA kernels against their plain PyTorch versions, on a card.

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
    xyz4 = ks.scatter_add(dest, payload, M_pad)
    g_sorted = ks.scatter_add(dest, g.T.contiguous(), M_pad)
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
def test_scatter_add_matches_plain(cuda):
    """Unique indices exact; repeated indices within f32 reordering."""
    rng = np.random.default_rng(1)
    M, C, rows = 100_000, 4, 131_072
    idx = torch.from_numpy(rng.permutation(rows)[:M]).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(ks.scatter_add(idx, vals, rows),
                               ks.scatter_add_plain(idx, vals, rows), rtol=0, atol=0)
    rid = torch.sort(torch.from_numpy(rng.integers(0, 512, M))).values.to(cuda)
    torch.testing.assert_close(ks.scatter_add(rid, vals, 512),
                               ks.scatter_add_plain(rid, vals, 512), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ks.scatter_add(idx, torch.zeros(4, 2, device=cuda), 3)
    with pytest.raises(ValueError):
        ks.scatter_add(idx.long(), torch.zeros(2, 4, device=cuda).T, 3)
