"""The chunked ray march against the JAX march, exactly: the cases of
`test_torch_march.py` (its set-up) that compile the JAX march, in a file
of four cases that the tier-1 run queues behind the longest JAX test
file."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.ops import march as jm
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.ops import march as tm
from test_torch_march import AABB, H, _bitfield, _rays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize(
    "M_budget,ladder_steps,ray_chunk_cap,chunk_budget,noise",
    [
        (4096, None, None, None, False),  # budget covers everything
        (1024, None, 8, 2048, False),  # eval first pass: cap + chunk budget
        (640, 128, None, None, True),  # ladder window + noise, budget drops
        (512, 64, 2, 256, False),  # every truncation mode at once
    ],
)
def test_march_rays_chunked_exact(M_budget, ladder_steps, ray_chunk_cap, chunk_budget,
                                  noise):
    """Integer outputs exact; t0 and resume_t equal too (the same f32
    expressions evaluate bit for bit) — allclose at 1 ulp is the stated
    tolerance for the floats."""
    N, S = 96, 256
    o, d = _rays(N, 4)
    bf = _bitfield(5)
    nears, fars = jax_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB), 0.05)
    nears, fars = np.asarray(nears), np.asarray(fars)
    nz = np.random.default_rng(6).uniform(size=N).astype(np.float32) if noise else None
    kw = dict(bound=1.0, cascades=1, grid_size=H, dt_gamma=0.0, max_steps=S,
              M_budget=M_budget, G=8, chunk_budget=chunk_budget,
              ladder_steps=ladder_steps, ray_chunk_cap=ray_chunk_cap)
    cj = jm.march_rays_chunked(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                               jnp.asarray(fars), jnp.asarray(bf),
                               noise=None if nz is None else jnp.asarray(nz), **kw)
    ct = tm.march_rays_chunked(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(nears.copy()), torch.from_numpy(fars.copy()),
                               torch.from_numpy(bf.copy()),
                               noise=None if nz is None else torch.from_numpy(nz), **kw)
    for name in ("sel", "sel_valid", "m_eff", "ray_mask", "num_points"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      np.asarray(getattr(cj, name)), err_msg=name)
    for name in ("t0", "resume_t"):
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1.2e-7, atol=0, err_msg=name)
    assert 0 < int(ct.m_eff) and (M_budget == 4096 or not bool(ct.ray_mask.all()))

    # ladder_samples on the selected prefix
    lk = dict(bound=1.0, cascades=1, grid_size=H, dt_gamma=0.0, max_steps=S)
    lj = jm.ladder_samples(cj.sel, jnp.asarray(o), jnp.asarray(d), cj.t0, **lk)
    lt = tm.ladder_samples(ct.sel, torch.from_numpy(o), torch.from_numpy(d), ct.t0, **lk)
    np.testing.assert_array_equal(lt[0].numpy(), np.asarray(lj[0]))
    for a, b in zip(lt[1:], lj[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1.2e-7, atol=1e-7)
