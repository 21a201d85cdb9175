"""The window encoder's plain versions against the JAX reference and its
kernel in interpret mode: the cases of `test_torch_window_encoder.py` (its
set-up and tolerances) that compile JAX programs, in a file of three cases
that the tier-1 run queues behind the longest JAX test file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.kernels.window_encoder import window_encode_binned as jax_binned
from tngp.ops.window_table import WindowSpec as JaxWindowSpec
from tngp.ops.window_table import window_encode_ref as jax_ref
from tngp.ops.window_table import window_view as jax_window_view
from tngp_torch.kernels import window_encoder as wk
from tngp_torch.ops import window_table as wt
from test_torch_window_encoder import SPEC_KW, _inputs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
