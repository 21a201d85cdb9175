"""Port parity for the window encoder's input gradient and for samples
outside the unit cube (D-NeRF encodes x + dx, which leaves the box near its
faces): forward, table gradient and position gradient of `tngp_torch`'s
`window_encode_binned(input_grads=True)` against the JAX package's binned
Pallas path in interpret mode (`mxu_f32=False`, `swap_select=True`,
`input_grads=True`), on samples with x01 in [-0.06, 1.06].  Also the
device-parity probes and the hash-product plain version, on the CPU.

Tolerances.  Forward: as inside the cube (`test_torch_window_encoder.py`),
the f32 order of the 8 corner products.  Table gradient: each entry within
(n - 1) 2^-24 sum|term| of the JAX kernel's (the terms are the same
bf16-rounded products, summed in another order).  Input gradient: per
sample and dimension the same L*C f32 products g * d, summed in another
order: within 2 (L*C) 2^-24 sum|g * d|.  Two effects of XLA's arithmetic
on the CPU come on top, both measured here:
- XLA contracts a weight factor such as 1 - f (or, with smoothstep, the
  polynomial f*f*(3-2f)) into a fused multiply-add, so a weight can differ
  from torch's by an f32 ulp of 1, 2^-23 absolute, even where the weight
  itself is near 0: each term may move by 2^-22 |g| times the weight's bound
  (1 for w, 1.5 scale for a derivative weight);
- on fewer than 1% of the entries such a difference flips a bf16 rounding
  of a weight or product; the entry then moves by at most one bf16 ulp,
  2^-7, of the products it holds, which the test allows on those entries
  only (2-3 entries per quantity here; the forward, which rounds weights
  that sum to 1, showed 2 of 4,096 with smoothstep)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.kernels.window_encoder import _P1_I32, _P2_I32
from tngp_torch.diagnostics import device_parity
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.kernels.int_mul import int_mul_hash, int_mul_hash_plain
from tngp_torch.kernels.scatter import scatter_add
from tngp_torch.ops import window_table as wt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# level 0 dense (side 17, 4,913 rows), level 1 hashed
SPEC_KW = dict(num_levels=2, level_dim=2, base_resolution=16, per_level_scale=2.0,
               log2_hashmap_size=14)
BLOCK = 64
U = 2.0**-24


def _inputs(spec, M=1024, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.06, 1.06, size=(3, M)).astype(np.float32)
    win = rng.normal(size=(spec.n_windows, spec.level_dim, 128, 64)).astype(np.float32)
    g = rng.normal(size=(spec.output_dim, M)).astype(np.float32)
    return x, win, g


def _sorted(x, spec):
    xt = torch.from_numpy(x)
    M = x.shape[1]
    dest, tob = wk.bin_dest(xt, BLOCK)
    xyz4 = scatter_add(dest, torch.cat([xt, torch.ones(1, M)]).T.contiguous(),
                       wk.padded_size(M, BLOCK))
    return xyz4, wk._wob_local(spec, tob), dest


def _dx_bounds(x, win, g, spec):
    """Per sample and dimension: sum |g * d| over the L*C terms;
    sum |g| sum_k |bf16(dw_k) bf16(t_k)| over every corner product; and the
    same with each |dw_k| replaced by its bound 1.5 scale_l."""
    L, C = spec.num_levels, spec.level_dim
    xyz4, wob, dest = _sorted(x, spec)
    table = torch.from_numpy(win)
    d = wk.dx_features(xyz4, wob, table, spec, BLOCK)  # [3, LC, M_pad]
    terms = torch.zeros_like(d)
    bounds = torch.zeros_like(d[0])
    for l in range(L):
        addr, _, dws = wk.sorted_corner_addresses(xyz4, wob, spec, BLOCK, l, deriv=True)
        for c in range(C):
            t = wt._bf16_round(table.reshape(-1)[addr + c * wt.WIN_ROWS]).abs()  # [8, M_pad]
            terms[:, l * C + c] = (wt._bf16_round(dws).abs() * t).sum(1)
            bounds[l * C + c] = 1.5 * spec.level_scale(l) * t.sum(0)
    ga = torch.from_numpy(np.abs(g))
    return ((ga[None] * d[:, :, dest].abs()).sum(1).numpy(),
            (ga[None] * terms[:, :, dest]).sum(1).numpy(),
            (ga * bounds[:, dest]).sum(0).numpy())


def _counts(x, spec):
    """Contributions per table entry (window layout)."""
    return device_parity._term_counts(torch.from_numpy(x), spec).numpy()


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_input_gradient_is_the_derivative_of_the_plain_encoder(interpolation):
    """Independently of JAX: without the bf16 roundings the derivative
    weights are what autograd derives from `window_encode_ref` (f32), so
    the two gradients agree to the rounding of every weight and table value
    to bf16: 2^-8 of each corner product, twice, and the f32 sums."""
    spec = wt.WindowSpec.create(**dict(SPEC_KW, interpolation=interpolation))
    x, win, g = _inputs(spec, M=600, seed=1)
    table = wt.window_unview(torch.from_numpy(win), spec)
    xa = torch.from_numpy(x).requires_grad_(True)
    (wt.window_encode_ref(xa, table, spec) * torch.from_numpy(g)).sum().backward()
    xb = torch.from_numpy(x).requires_grad_(True)
    (wk.window_encode_binned(xb, torch.from_numpy(win), spec, BLOCK, input_grads=True)
     * torch.from_numpy(g)).sum().backward()
    _, s_terms, _ = _dx_bounds(x, win, g, spec)
    err = (xa.grad - xb.grad).abs().numpy()
    assert (err <= (2 * 2.0**-8 + 2 * spec.output_dim * 8 * U) * s_terms + 1e-30).all()
    assert float(xb.grad.abs().max()) > 1.0


def test_without_input_grads_positions_get_none():
    spec = wt.WindowSpec.create(**SPEC_KW)
    x, win, _ = _inputs(spec, M=200)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(win).requires_grad_(True)
    wk.window_encode_binned(xt, tt, spec, BLOCK).sum().backward()
    assert xt.grad is None and tt.grad is not None


def test_hash_products_wrap_as_jax_int32():
    x = np.concatenate([np.arange(1 << 13), [-1, -5000, 2**31 - 1, -(2**31)]]).astype(np.int32)
    want = np.asarray((jnp.asarray(x) * _P1_I32) ^ (jnp.asarray(x) * _P2_I32))
    got = int_mul_hash(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int_mul_hash_plain(torch.from_numpy(x)).numpy(), want)


def test_device_parity_probes_pass_on_the_cpu():
    """The probes of `python -m tngp_torch.diagnostics.device_parity` at a
    small size: on the CPU every wrapper takes its plain version, so this
    checks the probes themselves (the card run holds the kernels)."""
    spec = wt.WindowSpec.create(**SPEC_KW)
    assert device_parity.run_probes(spec, n=512, device="cpu")
