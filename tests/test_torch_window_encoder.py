"""Port parity: the windowed grid encoder of `tngp_torch` against the JAX
package — plain encode vs `window_encode_ref(emulate_bf16=True)` and vs the
interpret-mode binned Pallas path, `bin_dest` exact, and the window layout
round trip.  On the CPU every wrapper takes its plain version; the CUDA
kernels are held against the same plain versions on the card by
`chip_smoke.py` and `tests/test_torch_kernels_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.kernels.window_encoder import bin_dest as jax_bin_dest
from tngp.kernels.window_encoder import bin_dest_pallas as jax_bin_dest_pallas
from tngp.kernels.window_encoder import window_encode_binned as jax_binned
from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp.ops.window_table import window_encode_ref as jax_ref
from tngp.ops.window_table import window_view as jax_window_view
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.ops import window_table as wt

SPEC_KW = dict(num_levels=5, level_dim=2, base_resolution=4, per_level_scale=2.0,
               log2_hashmap_size=15)


def _inputs(seed, M, spec):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(3, M)).astype(np.float32)
    table = rng.normal(size=(spec.total_rows, spec.level_dim)).astype(np.float32)
    return x, table


def test_spec_geometry_matches_jax():
    for kw in (SPEC_KW, dict(desired_resolution=2048)):
        a, b = JaxWindowSpec.create(**kw), wt.WindowSpec.create(**kw)
        assert a.win_offsets == b.win_offsets
        for x, y in zip(a.const_tables(), b.const_tables()):
            np.testing.assert_array_equal(x, y)
    flagship = wt.WindowSpec.create(desired_resolution=2048)
    assert flagship.n_windows == 749 and flagship.total_rows == 6_135_808


def test_window_view_roundtrip_and_layout():
    spec = wt.WindowSpec.create(**SPEC_KW)
    _, table = _inputs(0, 8, spec)
    win = wt.window_view(torch.from_numpy(table), spec)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_window_view(jnp.asarray(table), spec)))
    np.testing.assert_array_equal(wt.window_unview(win, spec).numpy(), table)


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_plain_ref_matches_jax_ref(interpolation):
    """Both emulate_bf16 settings.  Tolerance: the two packages may sum the
    8 corner products in another order; for N(0,1) table values (|v| < 5)
    and weights that sum to 1 that error is below 2 * 7 * 2^-24 * 5 = 4.2e-6."""
    kw = dict(SPEC_KW, interpolation=interpolation)
    spec = wt.WindowSpec.create(**kw)
    jspec = JaxWindowSpec.create(**kw)
    x, table = _inputs(1, 300, spec)
    for emulate in (False, True):
        got = wt.window_encode_ref(torch.from_numpy(x), torch.from_numpy(table), spec,
                                   emulate_bf16=emulate)
        want = jax_ref(jnp.asarray(x), jnp.asarray(table), jspec, emulate_bf16=emulate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=5e-6)


def test_binned_plain_matches_jax_emulating_ref_and_interpret_kernel():
    """The port's binned path (plain bin ranks, index_add_ sort, plain
    encoder forward, unsort) against the JAX bf16-emulating reference and the
    interpret-mode Pallas path with bf16 operands.  Tolerance: the f32
    corner-sum order, as above (bf16 x bf16 products are exact in f32)."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    jspec = JaxWindowSpec.create(**SPEC_KW)
    x, table = _inputs(2, 200, spec)
    win = np.array(jax_window_view(jnp.asarray(table), jspec))
    got = wk.window_encode_binned(torch.from_numpy(x), torch.from_numpy(win), spec, block=64)
    want_ref = jax_ref(jnp.asarray(x), jnp.asarray(table), jspec, emulate_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=1e-5, atol=5e-6)
    want_pallas = jax_binned(jnp.asarray(x), jnp.asarray(win), jspec, 64, False, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("M,block", [(200, 64), (1100, 512), (37, 128)])
def test_bin_dest_exact(M, block):
    """dest and tob are integers: exact against both JAX formulations."""
    rng = np.random.default_rng(M)
    x = rng.uniform(0, 1, size=(3, M)).astype(np.float32)
    x[:, : M // 3] *= 0.2  # crowd one tile so blocks overflow
    xt = torch.from_numpy(x)
    d_ref, t_ref = wk.bin_dest_ref(xt, block=block)
    d_k, t_k = wk.bin_dest(xt, block=block)
    d_j, t_j = jax_bin_dest(jnp.asarray(x), block=block)
    d_p, t_p = jax_bin_dest_pallas(jnp.asarray(x), block=block, interpret=True)
    for d, t in ((d_ref, t_ref), (d_k, t_k)):
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(d_k.numpy(), np.asarray(d_p))
    np.testing.assert_array_equal(t_k.numpy(), np.asarray(t_p))
    # an injection into tile-pure blocks
    assert len(set(d_k.tolist())) == M and int(d_k.max()) < wk.padded_size(M, block)


def test_bin_ranks_plain_counts_and_padding():
    keys = torch.tensor([3, 1, 3, -1] + [5] * 508, dtype=torch.int32)
    rank, tot = wk.bin_ranks_plain(keys)
    assert rank[:4].tolist() == [0, 0, 1, -1] and rank[-1] == 507
    assert tot[0, 3] == 2 and tot[0, 1] == 1 and tot[0, 5] == 508 and tot.sum() == 511
