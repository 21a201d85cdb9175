"""The stream compositor's VJP against the JAX package's and autodiff: the
cases of `test_torch_composite_vjp.py` (its set-up and tolerances), in a
file of four cases that the tier-1 run queues behind the longest JAX test
file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tngp.ops.composite import composite_stream as jax_composite
from tngp_torch.ops.composite import composite_stream, composite_stream_ref
from test_torch_composite_vjp import CASES, _atol, _stream, _torch_vjp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
