"""The window encoder's table gradient against the JAX kernel in interpret
mode: the cases of `test_torch_window_encoder_bwd.py` (its set-up and
tolerances) that compile JAX programs, in a file of four cases that the
tier-1 run queues behind the longest JAX test file."""

import numpy as np
import pytest

from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp_torch.ops import window_table as wt
from test_torch_window_encoder_bwd import (
    SPEC_KW,
    _abs_contrib_sum_and_count,
    _inputs,
    _jax_grad,
    _torch_grad,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
@pytest.mark.parametrize("mxu_f32", [False, True])
def test_table_gradient_matches_jax_interpret_kernel(interpolation, mxu_f32):
    kw = dict(SPEC_KW, interpolation=interpolation)
    spec, jspec = wt.WindowSpec.create(**kw), JaxWindowSpec.create(**kw)
    x, win, g = _inputs(3, 160, spec)
    got = _torch_grad(x, win, g, spec).numpy()
    want = _jax_grad(x, win, g, jspec, mxu_f32)
    sabs, n = _abs_contrib_sum_and_count(x, g, spec)
    tol = np.maximum(n - 1, 0) * 2.0**-24 * sabs  # f32 reordering
    flips = 0.0
    if mxu_f32:
        tol = tol + 2.0**-8 * sabs  # the port's one bf16 rounding per product
    elif interpolation == "smoothstep":
        # a flipped bf16 rounding, on few entries (module docstring)
        flips = np.mean(np.abs(got - want) > tol + 1e-30)
        assert flips < 0.01 * np.mean(sabs > 0)
        tol = tol + 2.0**-7 * sabs
    assert got.shape == want.shape == (spec.n_windows, 2, 128, 64)
    assert (np.abs(got - want) <= tol + 1e-30).all(), np.abs(got - want).max()
    assert np.abs(want).max() > 0.1  # the comparison is not of zeros
