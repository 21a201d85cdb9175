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
