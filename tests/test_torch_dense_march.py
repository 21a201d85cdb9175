"""The dense and stream marches and the march helpers of `tngp_torch/ops/
march.py` against `tngp/ops/march.py`, on `test_torch_march.py`'s rays (one
misses the box) and bitfields, with explicit noise:

- `march_rays_dense`: `mask` and `counts` exactly; `ts`, `dts` and
  `next_t` within 4 f32 ulps (5e-7 relative), `gaps` (differences of such
  t, through a cummax over the interleaved invalid rungs) within 2e-6 and
  positions within 1e-6 bound, the tolerances `test_torch_slab_march.py`
  states for the flat slab march; masked rungs at position 0 and dt 0;
- `march_rays_stream`: `mask` and `counts` exactly, `t0` and `next_t`
  within 5e-7 relative; its mask is the dense march's, and
  `ladder_samples` on a `compact_mask_hier` selection of it gives the
  dense march's positions and dts at those rungs bit for bit;
- `build_coarse_occupancy` (one and two cascades, hc 16 and 32, several
  dilations), `mip_level` and `grid_cell_index` exactly.

The marches compile JAX programs: this file has three cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_march import H, _bitfield, _rays
from tngp.ops import march as jm
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.ops import compaction as tcomp
from tngp_torch.ops import march as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bound,cascades,dt_gamma,S", [
    (1.0, 1, 0.0, 128),
    (2.0, 2, 1 / 128, 256),
])
def test_dense_and_stream_marches_exact(bound, cascades, dt_gamma, S):
    N = 48
    o, d = _rays(N, 5)
    o = o * np.float32(bound)
    bf = _bitfield(4, cascades)
    aabb = (-bound,) * 3 + (bound,) * 3
    nears, fars = jax_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    nears, fars = np.asarray(nears), np.asarray(fars)
    noise = np.random.default_rng(6).uniform(size=N).astype(np.float32)
    kw = dict(bound=bound, cascades=cascades, grid_size=H, dt_gamma=dt_gamma, max_steps=S)
    args_j = [jnp.asarray(a) for a in (o, d, nears, fars, bf)]
    args_t = [_t(a) for a in (o, d, nears, fars, bf)]

    rj = jm.march_rays_dense(*args_j, noise=jnp.asarray(noise), **kw)
    rt = tm.march_rays_dense(*args_t, noise=_t(noise), **kw)
    np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(rj.counts))
    m = rt.mask.numpy()
    assert m.any() and not m[0].any() and (m.sum(1) > 0).sum() > N // 2
    for name in ("ts", "dts", "next_t", "dirs_cf"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   rtol=5e-7, atol=0, err_msg=name)
    np.testing.assert_allclose(rt.gaps.numpy(), np.asarray(rj.gaps), rtol=0, atol=2e-6)
    np.testing.assert_allclose(rt.xyzs_cf.numpy(), np.asarray(rj.xyzs_cf), rtol=0,
                               atol=1e-6 * bound)
    assert (rt.xyzs_cf.numpy()[:, ~m] == 0).all() and (rt.dts.numpy()[~m] == 0).all()

    sj = jm.march_rays_stream(*args_j, noise=jnp.asarray(noise), **kw)
    st = tm.march_rays_stream(*args_t, noise=_t(noise), **kw)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))
    for name in ("t0", "next_t"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=5e-7, atol=0, err_msg=name)
    assert torch.equal(st.mask, rt.mask) and torch.equal(st.counts, rt.counts)

    # the stream's compacted samples are the dense march's rungs
    comp = tcomp.compact_mask_hier(st.mask, 256)
    ray_id, x_c, d_c, dt_c, _ = tm.ladder_samples(comp.sel, args_t[0], args_t[1], st.t0, **kw)
    v = comp.sel_valid
    assert int(v.sum()) == int(comp.m_eff) > 0
    assert torch.equal(x_c[:, v], rt.xyzs_cf.reshape(3, -1)[:, comp.sel[v]])
    assert torch.equal(dt_c[v], rt.dts.reshape(-1)[comp.sel[v]])
    assert torch.equal(d_c[:, v], args_t[1].T[:, ray_id[v]])


def test_coarse_occupancy_mip_level_and_cell_index_exact():
    live = []
    for cascades, bound in ((1, 1.0), (2, 2.0)):
        bf = _bitfield(7, cascades)
        for hc, halfext in ((16, 0.05), (32, 0.05), (16, 0.3), (32, 0.11)):
            kw = dict(bound=bound, cascades=cascades, grid_size=H, halfext=halfext, hc=hc)
            cj = jm.build_coarse_occupancy(jnp.asarray(bf), **kw)
            ct = tm.build_coarse_occupancy(_t(bf), **kw)
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj), err_msg=str(kw))
            live.append(float(ct.float().mean()))
    assert 0 < min(live) < 1, live
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-2.2, 2.2, (500, 3)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, 500).astype(np.float32)
    for cascades, bound in ((1, 1.0), (3, 4.0)):
        lj = jm.mip_level(jnp.asarray(xyz), jnp.asarray(dt), cascades, H)
        lt = tm.mip_level(_t(xyz), _t(dt), cascades, H)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        xb = np.clip(xyz, -bound, bound)
        cj = jm.grid_cell_index(jnp.asarray(xb), lj, bound, cascades, H)
        ct = tm.grid_cell_index(_t(xb), lt, bound, cascades, H)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert len(np.unique(ct.numpy())) > 100
