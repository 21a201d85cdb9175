"""The grouped slab march (`tngp_torch/ops/march.py` `march_rays(group=8)`)
against `tngp/ops/march.py` `march_rays(group=8)`, with one cascade,
with dt_gamma 1/128, and with three cascades (bound 4), explicit noise, and
one ray that misses the box:

- on a 64^3 grid per cascade holding a ball of radius 0.3 (so that coarse
  groups are skipped),
  the dilated coarse grid (`build_coarse_occupancy`, hc = min(32, H))
  exactly; `live`, the coarse probe at each group's t-midpoint, exactly
  against the JAX package's own expressions (`tngp/ops/march.py:917-932`,
  jitted); the selected groups (`_first_k_ranks`) and the live-group counts
  exactly; so the resume rung of `next_t` is exact;
- the march's `mask`, `counts` and every valid slot's rung exactly (JAX's
  rung recovered from its t as the nearest rung of the JAX ladder, as
  `test_torch_slab_march.py` does); `ts`, `dts` and `next_t` within 4 f32
  ulps (5e-7 relative) and `gaps` within 2e-6, positions within 1e-6 bound,
  the tolerances `test_torch_slab_march.py` states for the flat march
  (XLA's CPU fuses `o + t d` into an FMA, and its `exp` on the ladder's
  geometric part rounds up to 2 ulps from torch's);
- an iterated march from `next_t` (16^3 cells, 30% occupied; K 32, 4
  groups a round, so rays overflow) emits every rung of the scalar reference march
  (`tests/test_march.py` `sim_march`) exactly once, as
  `tests/test_march.py:177` holds the JAX march to, and the same
  samples as the JAX march round by round.

Each case compiles JAX programs, so this file has four cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_march import sim_march
from tngp.ops import march as jm
from tngp.ops import packbits as jax_packbits
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.ops import march as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GROUP = 8


def _scene(seed, C, H, bound, N=32, occupied=0.05, radius=None):
    """Rays from one side of the box towards its centre; each cascade's
    cells occupied at random (`occupied`), and within `radius` of the
    centre if given."""
    rng = np.random.default_rng(seed)
    grid = rng.uniform(size=(C, H, H, H)) < occupied
    if radius is not None:
        ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        grid |= (gx**2 + gy**2 + gz**2 < radius**2)[None]
    grid = grid.reshape(-1).astype(np.float32)
    bf = np.array(jax_packbits(jnp.asarray(grid), 0.5))
    o = rng.uniform(-2.5, -1.5, size=(N, 3)).astype(np.float32) * np.float32(bound)
    target = rng.uniform(-0.5, 0.5, size=(N, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 1.0, 0.0]  # misses the box
    aabb = jnp.asarray([-bound] * 3 + [bound] * 3, jnp.float32)
    nears, fars = jax_near_far(jnp.asarray(o), jnp.asarray(d), aabb, 0.05)
    noise = rng.uniform(size=N).astype(np.float32)
    return grid, bf, o, d.astype(np.float32), np.asarray(nears), np.asarray(fars), noise


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dt_gamma,C,bound,S", [
    (0.0, 1, 1.0, 256),
    (1 / 128, 1, 1.0, 512),
    (1 / 128, 3, 4.0, 512),
])
def test_grouped_march_exact(dt_gamma, C, bound, S):
    H, K, g = 64, 32, GROUP
    _, bf, o, d, nears, fars, noise = _scene(0, C, H, bound, occupied=0.0, radius=0.3)
    kw = dict(bound=bound, cascades=C, grid_size=H, dt_gamma=dt_gamma, max_steps=S, K=K)
    rj = jm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears), jnp.asarray(fars),
                       jnp.asarray(bf), noise=jnp.asarray(noise), group=g, **kw)
    rt = tm.march_rays(_t(o), _t(d), _t(nears), _t(fars), _t(bf), noise=_t(noise), group=g,
                       **kw)

    # the coarse stage, both packages, from the same noise-shifted origin
    dt_min, dt_max = tm._ladder_consts(S, C, H)
    halfext = 0.5 * g * (dt_min if dt_gamma <= 0 else dt_max)
    hc = min(32, H)
    cj = jm.build_coarse_occupancy(jnp.asarray(bf), bound=bound, cascades=C, grid_size=H,
                                   halfext=halfext, hc=hc)
    ct = tm.build_coarse_occupancy(_t(bf), bound=bound, cascades=C, grid_size=H,
                                   halfext=halfext, hc=hc)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert 0 < ct.float().mean() < 1

    @jax.jit
    def jax_live(o, d, nears, fars, noise, coarse):
        t0 = nears + jnp.clip(nears * dt_gamma, dt_min, dt_max) * noise
        jg = jnp.arange(S // g, dtype=jnp.int32) * g
        t_lo = jm._t_ladder(t0, jg, dt_gamma, dt_min, dt_max)
        t_hi = jm._t_ladder(t0, jg + (g - 1), dt_gamma, dt_min, dt_max)
        tc = 0.5 * (t_lo + t_hi)
        cix = [jnp.clip(jnp.floor((jnp.clip(o[:, c:c + 1] + tc * d[:, c:c + 1], -bound, bound)
                                   + bound) / (2.0 * bound) * hc), 0.0, float(hc - 1)
                        ).astype(jnp.int32) for c in range(3)]
        ccell = (cix[0] * hc + cix[1]) * hc + cix[2]
        live = jnp.take(coarse, ccell.reshape(-1)).reshape(tc.shape) & (t_lo < fars[:, None])
        return live, jm._first_k_ranks(live, K // g + 1)

    live_j, (found_j, lc_j) = jax_live(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                                       jnp.asarray(fars), jnp.asarray(noise), cj)
    t0 = tm._noisy_start(_t(nears), _t(noise), dt_gamma, dt_min, dt_max)
    live_t = tm._group_live(_t(o), _t(d), t0, _t(fars), ct, bound=bound, hc=hc, group=g,
                            max_steps=S, dt_gamma=dt_gamma, dt_min=dt_min, dt_max=dt_max)
    np.testing.assert_array_equal(live_t.numpy(), np.asarray(live_j))
    found_t, lc_t = tm._first_k_ranks(live_t, K // g + 1)
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(lc_t.numpy(), np.asarray(lc_j))
    assert int(lc_t.max()) > K // g  # some rays overflow their group budget

    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    m = np.asarray(rj.mask)
    assert m.any() and not m[0].any()
    t0j = np.asarray(jnp.asarray(nears) + jnp.clip(jnp.asarray(nears) * dt_gamma, dt_min, dt_max)
                     * jnp.asarray(noise))
    ladder = np.asarray(jm._t_ladder(jnp.asarray(t0j), jnp.arange(S), dt_gamma, dt_min, dt_max))
    rung_j = np.abs(ladder[:, None, :] - np.asarray(rj.ts)[:, :, None]).argmin(axis=2)
    np.testing.assert_array_equal(rt.sel_idx.numpy()[m], rung_j[m])
    for name in ("ts", "dts", "next_t", "dirs_cf"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=5e-7, atol=0, err_msg=name)
    np.testing.assert_allclose(rt.gaps.numpy(), np.asarray(rj.gaps), rtol=0, atol=2e-6)
    np.testing.assert_allclose(rt.xyzs_cf.numpy(), np.asarray(rj.xyzs_cf), rtol=0,
                               atol=1e-6 * bound)
    assert (rt.xyzs_cf.numpy()[:, ~m] == 0).all() and (rt.dts.numpy()[~m] == 0).all()


def test_grouped_march_resume_covers_everything():
    C, H, bound, S, K, g = 1, 16, 1.0, 256, 32, GROUP
    grid, bf, o, d, nears, fars, _ = _scene(3, C, H, bound, N=16, occupied=0.3)
    kw = dict(bound=bound, cascades=C, grid_size=H, dt_gamma=0.0, max_steps=S, K=K, group=g)
    got_t = [[] for _ in range(len(o))]
    tj, tt = jnp.asarray(nears), _t(nears)
    for _ in range(12):
        rj = jm.march_rays(jnp.asarray(o), jnp.asarray(d), tj, jnp.asarray(fars),
                           jnp.asarray(bf), **kw)
        rt = tm.march_rays(_t(o), _t(d), tt, _t(fars), _t(bf), **kw)
        np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
        np.testing.assert_allclose(rt.ts.numpy(), np.asarray(rj.ts), rtol=5e-7, atol=0)
        np.testing.assert_allclose(rt.next_t.numpy(), np.asarray(rj.next_t), rtol=5e-7, atol=0)
        m = rt.mask.numpy()
        for n in range(len(o)):
            got_t[n].extend(rt.ts.numpy()[n][m[n]].tolist())
        tj, tt = rj.next_t, rt.next_t
        if bool((rt.next_t >= _t(fars)).all()):
            break
    assert bool((tt >= _t(fars)).all())
    overflowed = 0
    for n in range(len(o)):
        want = [t for t, _ in sim_march(o[n], d[n], float(nears[n]), float(fars[n]),
                                        lambda cell: grid[cell] > 0.5, bound, C, H, 0.0, S)]
        got = np.array(sorted(got_t[n]))
        assert len(got) == len(want), (n, len(got), len(want))
        overflowed += len(want) > K
        if want:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert overflowed > 0
