"""Port parity: the `composite_stream` forward of `tngp_torch` against the
JAX package on the same compacted sample stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.ops.composite import composite_stream as jax_composite
from tngp_torch.ops.composite import _segmented_cumsum, composite_stream


def _stream(seed, n_rays, M, density):
    rng = np.random.default_rng(seed)
    rid = np.sort(rng.integers(0, n_rays, M)).astype(np.int32)
    valid = rng.uniform(size=M) < 0.9
    valid[-M // 8:] = False  # padding tail, as the march's fill slots
    sig = (rng.uniform(size=M) * density).astype(np.float32)
    rgb = rng.uniform(size=(3, M)).astype(np.float32)
    dt = rng.uniform(0.002, 0.02, size=M).astype(np.float32)
    gaps = rng.uniform(0.002, 0.05, size=M).astype(np.float32)
    tcum = np.cumsum(gaps).astype(np.float32)
    return sig, rgb, dt, gaps, rid, valid, tcum


@pytest.mark.parametrize("density,use_tcum", [(5.0, True), (400.0, False), (400.0, True)])
def test_composite_stream_matches_jax(density, use_tcum):
    """density 400 saturates rays, so the early-termination mask is live.
    Tolerance: the JAX segmented associative scan and the port's float64
    cumsum round differently (a few f32 ulps of the optical depth), which
    moves weights by ~1e-6 relative; 1e-5 leaves margin."""
    n_rays, M = 96, 4000
    sig, rgb, dt, gaps, rid, valid, tcum = _stream(int(density), n_rays, M, density)
    kw = dict(t_cum=tcum) if use_tcum else {}
    want = jax_composite(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dt),
                         jnp.asarray(gaps), jnp.asarray(rid), jnp.asarray(valid),
                         n_rays, 1e-4, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = composite_stream(torch.from_numpy(sig), torch.from_numpy(rgb),
                           torch.from_numpy(dt), torch.from_numpy(gaps),
                           torch.from_numpy(rid), torch.from_numpy(valid), n_rays,
                           1e-4, **{k: torch.from_numpy(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if density > 100:  # the early-termination mask was exercised
        assert (got[0].numpy() > 0.9999).any()


def test_segmented_cumsum_keeps_f32_accuracy_on_long_streams():
    """A float32 global-cumsum-minus-base would lose ~1e-3 relative here; the
    port stays at f32 rounding of the segment sums."""
    M = 400_000
    vals = torch.full((M,), 0.01)
    is_start = torch.zeros(M, dtype=torch.bool)
    is_start[::100] = True
    out = _segmented_cumsum(vals, is_start)
    want = (torch.arange(M) % 100 + 1).double() * 0.01
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-7)
