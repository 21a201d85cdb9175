"""Port parity: the table gradient of `tngp_torch`'s `window_encode_binned`
against `jax.grad` through the JAX package's interpret-mode binned Pallas
path, in both of its MXU modes, and the port's sorted plain backward against
its unsorted canonical-layout oracle.  On the CPU every wrapper takes its
plain version; the CUDA backward kernel is held against the same plain
version on the card by `chip_smoke.py` and `tests/test_torch_kernels_gpu.py`.

Tolerances.  Each table entry is a sum of contributions c_i.  Two f32 sums
of the same n terms in another order differ by at most (n - 1) 2^-24
sum|c_i|.  The port rounds every product w * g to bf16 (the TPU default);
the JAX kernel with `mxu_f32=True` does not, which moves each term by at
most 2^-8 |c_i| (half a bf16 ulp: bf16 keeps 8 significant bits).  With smoothstep XLA evaluates the
weight polynomial f*f*(3-2f) with other roundings than torch, so a weight
can differ by an f32 ulp and a product on a bf16 rounding boundary then
rounds the other way: a whole bf16 ulp, 2^-7 |c_i|, on a few entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.kernels.window_encoder import window_encode_binned as jax_binned
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.ops import window_table as wt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SPEC_KW = dict(num_levels=4, level_dim=2, base_resolution=4, per_level_scale=2.0,
               log2_hashmap_size=15)
BLOCK = 64


def _inputs(seed, M, spec, crowd=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(3, M)).astype(np.float32)
    if crowd:  # every sample in tile 0: many contributions per coarse row
        x *= 0.24
    win = rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64)).astype(np.float32)
    g = rng.normal(size=(spec.output_dim, M)).astype(np.float32)
    return x, win, g


def _torch_grad(x, win, g, spec):
    table = torch.from_numpy(win).requires_grad_(True)
    out = wk.window_encode_binned(torch.from_numpy(x), table, spec, BLOCK)
    # a non-contiguous cotangent, as the MLP's backward hands over
    (out * torch.from_numpy(np.ascontiguousarray(g.T)).T).sum().backward()
    return table.grad


def _jax_grad(x, win, g, jspec, mxu_f32):
    def loss(t):
        return jnp.sum(jax_binned(jnp.asarray(x), t, jspec, BLOCK, mxu_f32, True) * g)

    return np.asarray(jax.grad(loss)(jnp.asarray(win)))


def _abs_contrib_sum_and_count(x, g, spec):
    """Per table entry (window layout): sum |w * g| over its contributions
    and their number n."""
    xt = torch.from_numpy(x)
    s = wt.window_table_grad_ref(xt, torch.from_numpy(np.abs(g)), spec)
    n = torch.zeros(spec.total_rows)
    tile = wt.sample_tiles(xt)
    for level in range(spec.num_levels):
        rows, _ = wt._corner_rows(spec, level, xt)
        w_id = spec.win_offsets[level] + torch.from_numpy(spec.tile_window(level)).long()[tile]
        n.index_add_(0, (w_id[None] * wt.WIN_ROWS + rows).reshape(-1), torch.ones(rows.numel()))
    n = n[:, None].expand(-1, spec.level_dim)
    return wt.window_view(s, spec).numpy(), wt.window_view(n, spec).numpy()


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_sorted_plain_backward_matches_canonical_oracle(interpolation):
    """`window_encode_bwd_plain` (sorted samples, window layout) against
    `window_table_grad_ref(emulate_bf16=True)` (unsorted, canonical layout):
    the same bf16-rounded terms in another order."""
    spec = wt.WindowSpec.create(**dict(SPEC_KW, interpolation=interpolation))
    x, win, g = _inputs(11, 300, spec)
    got = _torch_grad(x, win, g, spec)
    want = wt.window_view(
        wt.window_table_grad_ref(torch.from_numpy(x), torch.from_numpy(g), spec,
                                 emulate_bf16=True), spec)
    sabs, n = _abs_contrib_sum_and_count(x, g, spec)
    tol = np.maximum(n - 1, 0) * 2.0**-24 * sabs + 1e-30
    assert (np.abs(got.numpy() - want.numpy()) <= tol).all()


def test_canonical_oracle_is_autograd_of_the_plain_encoder():
    """Without bf16 rounding the oracle is the gradient torch derives from
    `window_encode_ref`; positions get no gradient from the binned path."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    x, _, g = _inputs(13, 200, spec)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.normal(size=(spec.total_rows, 2)).astype(np.float32)).requires_grad_(True)
    (wt.window_encode_ref(torch.from_numpy(x), table, spec) * torch.from_numpy(g)).sum().backward()
    want = table.grad
    got = wt.window_table_grad_ref(torch.from_numpy(x), torch.from_numpy(g), spec)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x).requires_grad_(True)
    win = wt.window_view(table.detach(), spec).contiguous().requires_grad_(True)
    wk.window_encode_binned(xt, win, spec, BLOCK).sum().backward()
    assert xt.grad is None and win.grad is not None
