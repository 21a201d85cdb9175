"""Out-of-range samples and the input gradient against the JAX kernel in
interpret mode: the cases of `test_torch_window_encoder_dx.py` (its set-up
and tolerances) that compile JAX programs, in a file that the tier-1 run
queues behind the longest JAX test file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.kernels.window_encoder import window_encode_binned as jax_binned
from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.ops import window_table as wt
from test_torch_window_encoder_dx import BLOCK, SPEC_KW, U, _counts, _dx_bounds, _inputs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_out_of_range_samples_and_input_gradient_match_jax_interpret_kernel(interpolation):
    kw = dict(SPEC_KW, interpolation=interpolation)
    spec, jspec = wt.WindowSpec.create(**kw), JaxWindowSpec.create(**kw)
    assert spec.level_dense(0) and spec.level_side(0) == 17 and not spec.level_dense(1)
    x, win, g = _inputs(spec)
    inside = ((x >= 0) & (x <= 1)).all(axis=0)
    assert 0.5 < inside.mean() < 0.9

    def loss(xx, tt):
        f = jax_binned(xx, tt, jspec, BLOCK, False, True, True, True)
        return jnp.sum(f * g), f

    # jitted: for the encoder alone jit and op by op agree (measured: forward
    # and table gradient bit for bit, positions' gradient to its sum order)
    (_, jf), (jgx, jgt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(win))
    jf, jgx, jgt = np.asarray(jf), np.asarray(jgx), np.asarray(jgt)

    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(win).requires_grad_(True)
    out = wk.window_encode_binned(xt, tt, spec, BLOCK, input_grads=True)
    # a non-contiguous cotangent, as the MLP's backward hands over
    (out * torch.from_numpy(np.ascontiguousarray(g.T)).T).sum().backward()

    # forward: outside the cube as inside (the clamp this replaces was off by
    # up to 0.587 at level 0 here)
    xs = torch.from_numpy(x)
    f_abs = wt.window_encode_ref(xs, wt.window_unview(torch.from_numpy(np.abs(win)), spec),
                                 spec, emulate_bf16=True).numpy()
    err = np.abs(out.detach().numpy() - jf)
    flips = err > 1e-5 * np.abs(jf) + 5e-6
    assert flips.mean() < 0.01 and (interpolation == "smoothstep" or not flips.any())
    assert (err <= 1e-5 * np.abs(jf) + 5e-6 + flips * 2.0**-7 * f_abs).all(), err.max()
    assert np.abs(jf[:, ~inside]).max() > 0.5

    # table gradient
    sabs = wt.window_view(wt.window_table_grad_ref(
        torch.from_numpy(x), torch.from_numpy(np.abs(g)), spec), spec).numpy()
    n = _counts(x, spec)
    tol = np.maximum(n - 1, 0) * U * sabs + n * 2.0**-22 * np.abs(g).max()
    err = np.abs(tt.grad.numpy() - jgt)
    flips = err > tol + 1e-30
    assert flips.mean() < 0.01 * np.mean(sabs > 0), flips.sum()
    assert (err <= tol + flips * 2.0**-7 * sabs + 1e-30).all(), err.max()

    # input gradient, inside and outside the cube
    s_gd, s_terms, s_bound = _dx_bounds(x, win, g, spec)
    tol = 2 * spec.output_dim * U * s_gd + 2.0**-22 * s_bound
    err = np.abs(xt.grad.numpy() - jgx)
    flips = err > tol + 1e-30
    for part in (inside, ~inside):
        assert flips[:, part].mean() < 0.01, flips[:, part].mean()
    assert (err <= tol + flips * 2.0**-7 * s_terms + 1e-30).all(), err.max()
    assert np.abs(jgx[:, inside]).max() > 1.0 and np.abs(jgx[:, ~inside]).max() > 1.0
