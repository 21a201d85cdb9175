"""Port parity: `tngp_torch.kernels.scatter.scatter_add` against the JAX
package's scatter semantics `jnp.zeros(...).at[idx].add(vals)` for the two
index patterns of the eval path — unique (the encoder's payload sort) and
nondecreasing with repeats (the compositor's per-ray reduction)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp_torch.kernels.scatter import scatter_add, scatter_add_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _jax_scatter(idx, vals, rows):
    return np.asarray(jnp.zeros((rows, vals.shape[1]), jnp.float32).at[idx].add(vals))


@pytest.mark.parametrize("pattern", ["unique", "sorted", "random"])
def test_scatter_add_matches_jax(pattern):
    """Unique indices: exact.  Repeated indices: both sides add in index
    order on the CPU, so the sums agree to f32 rounding of ~100-term sums
    (rtol 1e-6); the card's atomic order is held to rtol 1e-5 in
    chip_smoke.py."""
    rng = np.random.default_rng(0)
    M, C, rows = 3000, 5, 257
    vals = rng.normal(size=(M, C)).astype(np.float32)
    if pattern == "unique":
        rows = 4096
        idx = rng.permutation(rows)[:M]
    elif pattern == "sorted":
        idx = np.sort(rng.integers(0, rows, M))
    else:
        idx = rng.integers(0, rows, M)
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), rows).numpy()
    want = _jax_scatter(jnp.asarray(idx), jnp.asarray(vals), rows)
    if pattern == "unique":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scatter_add_plain_is_cpu_route():
    idx = torch.tensor([2, 0, 2])
    vals = torch.ones(3, 2)
    out = scatter_add(idx, vals, 4)
    assert out.tolist() == [[1, 1], [0, 0], [2, 2], [0, 0]]
    torch.testing.assert_close(out, scatter_add_plain(idx, vals, 4))
