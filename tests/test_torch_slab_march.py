"""The slab march (`tngp_torch/ops/march.py` `march_rays`) and the slab
compositor (`tngp_torch/ops/composite.py` `composite_rays_cf`) against
`tngp/ops/march.py` `march_rays` (group 0) and `tngp/ops/composite.py`,
on `test_torch_march.py`'s rays (one that misses the box) and bitfields:

- the march on explicit noise: `mask`, `counts` and every slot's selected
  rung exactly (JAX's rung recovered from its t as the nearest rung of the
  JAX ladder, whose rungs lie dt apart, far more than the t's rounding);
  `ts`, `dts` and `next_t` within 4 f32 ulps (5e-7 relative: the same f32
  expressions, but on the geometric part of the ladder XLA's `exp` and
  torch's round up to 2 ulps apart), `gaps`, differences of such t, within
  2e-6 absolute; the positions `o + t d` within 1e-6 bound absolute: t's
  ulps times |d|, and XLA's CPU fuses the product and the sum into one FMA
  where the port rounds twice, an ulp of the terms, which reach 2.5 bound
  here (measured 1.2e-7 at bound 1 and 1.06e-6 at bound 2; a coordinate
  near 0 makes that a large relative error); masked slots at position 0 and dt 0 — with
  one cascade, with two (bound 2,
  dt_gamma 1/128), and with fewer rungs than slots (S = 96 < K + 1 on
  rays that overflow K = 24);
- the compositor on random slabs, forward and the gradients of sigmas and
  colours (the JAX side under `jit`, as the CC step runs it): the early stop `T_after < T_thresh` compares an `exp` of a
  cumulative sum, which the two packages may round an ulp apart, so a
  sample can flip between alive and stopped: flips are counted against the
  JAX weights (at most 1 of the 2,560 samples, none measured), and the
  rays without a flip held to 1e-6 (weights, depth, image) and 1e-5
  (gradients, norm-relative over those rays).
The march compiles the JAX program, so this file has four cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.ops import composite as jc
from tngp.ops import march as jm
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.ops import composite as tc
from tngp_torch.ops import march as tm
from test_torch_march import H, _bitfield, _rays
from torch_tensorf_helpers import rel_err
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("bound,cascades,dt_gamma,S,K", [
    (1.0, 1, 0.0, 256, 24),
    (2.0, 2, 1 / 128, 256, 32),
    (1.0, 1, 0.0, 96, 24),
])
def test_slab_march_exact(bound, cascades, dt_gamma, S, K):
    N = 64
    o, d = _rays(N, 7)
    o = o * np.float32(bound)
    bf = _bitfield(8, cascades)
    aabb = (-bound,) * 3 + (bound,) * 3
    nears, fars = jax_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    nears, fars = np.asarray(nears), np.asarray(fars)
    noise = np.random.default_rng(9).uniform(size=N).astype(np.float32)
    kw = dict(bound=bound, cascades=cascades, grid_size=H, dt_gamma=dt_gamma,
              max_steps=S, K=K)
    rj = jm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears), jnp.asarray(fars),
                       jnp.asarray(bf), noise=jnp.asarray(noise), **kw)
    rt = tm.march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(nears.copy()),
                       torch.from_numpy(fars.copy()), torch.from_numpy(bf.copy()),
                       noise=torch.from_numpy(noise), **kw)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    assert int(rt.counts.max()) > K and 0 < int(rt.mask.sum()) < N * K
    # JAX's selected rungs, from its t
    dt_min = 2.0 * jm.SQRT3 / S
    dt_max = 2.0 * jm.SQRT3 * 2 ** (cascades - 1) / kw["grid_size"]
    t0 = np.asarray(jnp.asarray(nears) + jnp.clip(jnp.asarray(nears) * dt_gamma, dt_min, dt_max)
                    * jnp.asarray(noise))
    ladder = np.asarray(jm._t_ladder(jnp.asarray(t0), jnp.arange(S), dt_gamma, dt_min, dt_max))
    m = np.asarray(rj.mask)
    tj = np.asarray(rj.ts)
    rung_j = np.abs(ladder[:, None, :] - tj[:, :, None]).argmin(axis=2)  # the nearest rung
    np.testing.assert_array_equal(rt.sel_idx.numpy()[m], rung_j[m])
    for name in ("ts", "dts", "next_t", "dirs_cf"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=5e-7, atol=0, err_msg=name)
    np.testing.assert_allclose(rt.gaps.numpy(), np.asarray(rj.gaps), rtol=0, atol=2e-6)
    np.testing.assert_allclose(rt.xyzs_cf.numpy(), np.asarray(rj.xyzs_cf), rtol=0,
                               atol=1e-6 * bound)
    assert (rt.xyzs_cf.numpy()[:, ~m] == 0).all() and (rt.dts.numpy()[~m] == 0).all()


def test_slab_compositor_matches():
    N, K = 80, 32
    rng = np.random.default_rng(11)
    sig = (rng.exponential(3.0, (N, K)) * (rng.uniform(size=(N, K)) < 0.8)).astype(np.float32)
    sig[:10] *= 60.0  # rays that stop early
    rgb = rng.uniform(size=(3, N, K)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, (N, K)).astype(np.float32)
    gaps = (dts * rng.uniform(1.0, 3.0, (N, K))).astype(np.float32)
    mask = rng.uniform(size=(N, K)) < 0.9
    gw = rng.normal(size=(N,)).astype(np.float32)
    gd = rng.normal(size=(N,)).astype(np.float32)
    gi = rng.normal(size=(N, 3)).astype(np.float32)

    def jloss(s, c):
        ws, dep, img, w = jc.composite_rays_cf(s, c, jnp.asarray(dts), jnp.asarray(gaps),
                                               jnp.asarray(mask), 1e-4)
        return (ws * gw).sum() + (dep * gd).sum() + (img * gi).sum(), (ws, dep, img, w)

    (_, jout), (jgs, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(sig), jnp.asarray(rgb))
    ts_, tc_ = torch.tensor(sig, requires_grad=True), torch.tensor(rgb, requires_grad=True)
    tout = tc.composite_rays_cf(ts_, tc_, torch.tensor(dts), torch.tensor(gaps),
                                torch.tensor(mask), 1e-4)
    ((tout[0] * torch.tensor(gw)).sum() + (tout[1] * torch.tensor(gd)).sum()
     + (tout[2] * torch.tensor(gi)).sum()).backward()
    wj, wt = np.asarray(jout[3]), tout[3].detach().numpy()
    flips = ((wj == 0) != (wt == 0)) & mask
    assert int(flips.sum()) <= 1
    ok = ~flips.any(axis=1)
    assert (wj[:10] == 0).any()  # the early stop happened
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.detach().numpy()[ok], np.asarray(b)[ok], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(wt[ok], wj[ok], rtol=1e-6, atol=1e-6)
    assert rel_err(ts_.grad.numpy()[ok], np.asarray(jgs)[ok]) <= 1e-5
    assert rel_err(tc_.grad.numpy()[:, ok], np.asarray(jgc)[:, ok]) <= 1e-5
