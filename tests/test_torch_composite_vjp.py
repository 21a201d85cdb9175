"""Port parity: `composite_stream` forward and all four gradients (`sigmas`,
`rgbs_cf`, `dts`, `t_cum`) of `tngp_torch`'s closed-form backward against
the JAX package under `jax.vjp`, and against the port's own autodiff twin
`composite_stream_ref`; `trunc_exp`'s clamped backward.

Tolerance of the gradients: both packages evaluate the same closed form,
but the JAX segmented associative scan and the port's float64 cumsum round
the optical depth and the suffix sum differently (a few f32 ulps), which
moves a gradient by ~1e-6 of the largest term that enters it.  The terms
are O(1) for `sigmas`, `rgbs_cf` and `t_cum` and O(sigma) for `dts`
(d_dt = dtau * sigma, sigma up to 400), so rtol 2e-5 and atol 2e-6 of the
gradient's largest entry, floored at 2e-5."""


def _atol(grad):
    return 2e-6 * max(10.0, float(np.abs(grad).max()))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.ops.activation import trunc_exp as jax_trunc_exp
from tngp.ops.composite import composite_stream as jax_composite
from tngp_torch.ops.activation import trunc_exp
from tngp_torch.ops.composite import composite_stream, composite_stream_ref


def _stream(seed, n_rays, M, density, pad_tail=True, skip_rays=False):
    rng = np.random.default_rng(seed)
    rays = np.arange(n_rays)
    if skip_rays:  # rays with no sample at all, first and last included
        rays = rays[(rays % 3 != 0) & (rays != n_rays - 1)]
    rid = np.sort(rng.choice(rays, M)).astype(np.int32)
    valid = rng.uniform(size=M) < 0.9
    if pad_tail:
        valid[-M // 8:] = False  # padding tail, as the march's fill slots
    sig = (rng.uniform(size=M) * density).astype(np.float32)
    rgb = rng.uniform(size=(3, M)).astype(np.float32)
    dt = rng.uniform(0.002, 0.02, size=M).astype(np.float32)
    tcum = np.cumsum(rng.uniform(0.002, 0.05, size=M)).astype(np.float32) % 3.0
    cot = (rng.normal(size=n_rays).astype(np.float32), rng.normal(size=n_rays).astype(np.float32),
           rng.normal(size=(n_rays, 3)).astype(np.float32))
    return sig, rgb, dt, rid, valid, tcum, cot


def _torch_vjp(fn, sig, rgb, dt, rid, valid, tcum, cot, n_rays):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (sig, rgb, dt, tcum)]
    out = fn(leaves[0], leaves[1], leaves[2], None, torch.from_numpy(rid),
             torch.from_numpy(valid), n_rays, 1e-4, t_cum=leaves[3])
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot)).backward()
    return [o.detach().numpy() for o in out], [l.grad.numpy() for l in leaves]


CASES = {
    "thin": dict(density=5.0),
    "early_termination": dict(density=400.0),
    "no_padding": dict(density=60.0, pad_tail=False),
    "rays_without_samples": dict(density=60.0, skip_rays=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_stream_vjp_matches_jax_and_autodiff(case):
    n_rays, M = 64, 3000
    sig, rgb, dt, rid, valid, tcum, cot = _stream(len(case), n_rays, M, **CASES[case])

    def jf(s, r, d, t):
        return jax_composite(s, r, d, None, jnp.asarray(rid), jnp.asarray(valid), n_rays,
                             1e-4, t_cum=t)

    want_out, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (sig, rgb, dt, tcum)))
    want_grads = vjp(tuple(jnp.asarray(c) for c in cot))
    got_out, got_grads = _torch_vjp(composite_stream, sig, rgb, dt, rid, valid, tcum, cot,
                                    n_rays)
    ref_out, ref_grads = _torch_vjp(composite_stream_ref, sig, rgb, dt, rid, valid, tcum,
                                    cot, n_rays)
    for g, w, r in zip(got_out, want_out, ref_out):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    for name, g, w, r in zip(("sigmas", "rgbs_cf", "dts", "t_cum"), got_grads, want_grads,
                             ref_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=_atol(g), err_msg=name)
        # the autodiff twin differentiates through the early-stop mask as a
        # constant, like the closed form; only summation order differs
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=_atol(g),
                                   err_msg=name + " (autodiff)")
        assert np.abs(g).max() > 1e-3, name
    # padding slots get no sigma gradient; rays without samples composite to 0
    assert (got_grads[0][~valid] == 0).all()
    if case == "early_termination":
        assert (got_out[0] > 0.9999).any()
    if case == "rays_without_samples":
        empty = np.setdiff1d(np.arange(n_rays), rid)
        assert len(empty) > 10 and (got_out[0][empty] == 0).all()


def test_composite_stream_gaps_path_is_differentiable():
    """Without t_cum the advance is scanned from `gaps` outside the
    closed-form core; its gradient reaches `gaps` through torch's autograd of
    the scan, and matches the autodiff twin (the forward with gaps is held
    to JAX in test_torch_composite.py)."""
    n_rays, M = 16, 400
    sig, rgb, dt, rid, valid, _, cot = _stream(1, n_rays, M, 50.0)
    gaps = np.random.default_rng(2).uniform(0.002, 0.05, M).astype(np.float32)
    grads = []
    for fn in (composite_stream, composite_stream_ref):
        s, g = (torch.from_numpy(a).requires_grad_(True) for a in (sig, gaps))
        out = fn(s, torch.from_numpy(rgb), torch.from_numpy(dt), g, torch.from_numpy(rid),
                 torch.from_numpy(valid), n_rays, 1e-4)
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot)).backward()
        grads.append((s.grad.numpy(), g.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=_atol(a))
        assert np.abs(a).max() > 1e-3


def test_trunc_exp_backward_is_clamped():
    """Forward exp(x); backward g * exp(clamp(x, -15, 15)), exact at +-20."""
    x = np.array([-20.0, -15.0, -1.0, 0.0, 3.0, 15.0, 20.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.backward(torch.full_like(y, 2.0))
    yj, vjp = jax.vjp(jax_trunc_exp, jnp.asarray(x))
    (gj,) = vjp(jnp.full_like(yj, 2.0))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[[0, -1]], 2.0 * np.exp([-15.0, 15.0]), rtol=1e-6)
