"""Port parity for `tngp_torch/ops/grid_sample.py` against
`tngp/ops/grid_sample.py`: the bilinear (plane [3, 7, 9]) and linear (line
[3, 11]) samples, both `align_corners`, at 96 coordinates in [-1.2, 1.2]
(out-of-range corners weighted 0) plus the exact ends -1 and 1; forward and
VJP (plane or line gradient, coordinate gradients) on a random cotangent.

Tolerances:
- forward against the JAX function op by op (no `jit`): bit for bit, the
  same f32 operations in the same order; against the JITted JAX function
  1e-6 (XLA's CPU may fuse a multiply and an add into one FMA, one rounding
  instead of two); against `F.grid_sample` (a third witness, torch's own
  weights) 1e-5;
- the plane / line gradient: each entry sums the weighted cotangents of
  every corner that lands on it; `index_add_` (the CPU's plain version of
  `scatter_add_any`) and XLA's scatter add them in other orders, so an
  entry of n terms lies within (n - 1) 2^-24 sum|terms| of the exact sum in
  either: held at 2 (n - 1) 2^-24 sum|terms| per entry, n and sum|terms|
  counted here;
- coordinate gradients (sums over R = 3 channels, in einsum's order in JAX):
  1e-6 relative and absolute.
The cases compile small JAX programs, so this file has four."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tngp.ops.grid_sample as jgs
from tngp_torch.ops import grid_sample as tgs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 98


def _inputs(dim: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = (3, 7, 9) if dim == 2 else (3, 11)
    table = rng.normal(size=shape).astype(np.float32)
    coords = [np.concatenate([rng.uniform(-1.2, 1.2, B - 2), [-1.0, 1.0]]).astype(np.float32)
              for _ in range(dim)]
    g = rng.normal(size=(3, B)).astype(np.float32)
    return table, coords, g


def _torch_witness(table, coords, align):
    if len(coords) == 2:
        grid = torch.tensor(np.stack(coords, -1)).view(1, -1, 1, 2)
        src = torch.tensor(table)[None]
    else:
        grid = torch.tensor(np.stack([np.zeros_like(coords[0]), coords[0]], -1)).view(1, -1, 1, 2)
        src = torch.tensor(table)[None, :, :, None]
    return F.grid_sample(src, grid, align_corners=align, padding_mode="zeros")[0, :, :, 0].numpy()


def _entry_bound(idx_list, w_list, g, rows):
    """2 (n - 1) 2^-24 sum|terms| for each entry of the gradient [rows, R]."""
    n = np.zeros(rows)
    sabs = np.zeros((rows, g.shape[0]))
    for idx, w in zip(idx_list, w_list):
        np.add.at(n, idx, (w != 0).astype(np.float64))
        np.add.at(sabs, idx, np.abs(g.T * w[:, None]).astype(np.float64))
    return 2 * np.maximum(n - 1, 0)[:, None] * 2.0**-24 * sabs


@pytest.mark.parametrize("dim,align", [(2, True), (2, False), (1, True), (1, False)])
def test_grid_sample_forward_and_vjp_match(dim, align):
    table, coords, g = _inputs(dim, seed=dim * 10 + align)
    jtab, jco = jnp.asarray(table), [jnp.asarray(c) for c in coords]
    fwd_j = jgs.grid_sample_2d_cf if dim == 2 else jgs.grid_sample_1d_cf
    vjp_j = jgs.grid_sample_2d_cf_vjp if dim == 2 else jgs.grid_sample_1d_cf_vjp
    fwd_t = tgs.grid_sample_2d_cf if dim == 2 else tgs.grid_sample_1d_cf
    vjp_t = tgs.grid_sample_2d_cf_vjp if dim == 2 else tgs.grid_sample_1d_cf_vjp

    want = np.asarray(fwd_j(jtab, *jco, align_corners=align))
    want_jit = np.asarray(jax.jit(fwd_j, static_argnames="align_corners")(
        jtab, *jco, align_corners=align))
    ttab = torch.tensor(table, requires_grad=True)
    tco = [torch.tensor(c, requires_grad=True) for c in coords]
    got = vjp_t(ttab, *tco, align_corners=align)
    np.testing.assert_array_equal(fwd_t(ttab.detach(), *coords_t(coords), align_corners=align)
                                  .numpy(), want)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(got.detach().numpy(), want_jit, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, _torch_witness(table, coords, align), rtol=1e-5, atol=1e-5)

    # VJP
    _, pull = jax.vjp(lambda t, *c: vjp_j(t, *c, align_corners=align), jtab, *jco)
    jgrads = [np.asarray(x) for x in pull(jnp.asarray(g))]
    got.backward(torch.tensor(g))
    tgrads = [ttab.grad.numpy()] + [c.grad.numpy() for c in tco]

    # the gradient table, entry by entry within the reordering bound
    if dim == 2:
        H, W = table.shape[1:]
        corners, _, _ = tgs._corners_2d(H, W, *coords_t(coords), align)
        rows = H * W
    else:
        corners = tgs._corners_1d(table.shape[1], *coords_t(coords), align)
        rows = table.shape[1]
    bound = _entry_bound([c[0].numpy() for c in corners], [c[1].numpy() for c in corners],
                         g, rows)
    diff = np.abs(tgrads[0].reshape(3, rows).T.astype(np.float64)
                  - jgrads[0].reshape(3, rows).T)
    assert (diff <= bound).all(), float((diff - bound).max())
    assert np.abs(jgrads[0]).max() > 0
    for a, b in zip(tgrads[1:], jgrads[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert np.abs(b).max() > 0


def coords_t(coords):
    return [torch.tensor(c) for c in coords]
