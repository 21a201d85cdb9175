"""Near/far, packbits and the occupancy probe, the static nonzero, and the
occupancy grid's creation and cell centres on the blob scene against the
JAX package: cases of `test_torch_march.py` (its set-up) that compile JAX
programs, in a file that the tier-1 run queues behind the longest JAX test
file."""

import jax.numpy as jnp
import numpy as np
import torch

from tngp.ops import grid_utils as jgu
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.ops import grid_utils as tgu
from tngp_torch.ops import march as tm
from tngp_torch.ops.rays import near_far_from_aabb
from test_torch_march import AABB, H, _both, _rays
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_near_far_packbits_probe_match():
    o, d = _rays(64, 0)
    (nj, fj), (nt, ft) = _both(
        lambda a, b: jax_near_far(a, b, jnp.asarray(AABB), 0.05),
        lambda a, b: near_far_from_aabb(a, b, AABB, 0.05), o, d)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    rng = np.random.default_rng(1)
    grid = rng.uniform(size=(2, 4096)).astype(np.float32)
    bj, bt = _both(lambda g: jgu.packbits(g, 0.7), lambda g: tgu.packbits(g, 0.7), grid)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    cells = rng.integers(0, 8192, 5000)
    pj, pt = _both(jgu.bitfield_probe, tgu.bitfield_probe, np.asarray(bj).reshape(-1), cells)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(pt.numpy(), grid.reshape(-1)[cells] > 0.7)


def test_nonzero_static_matches_jnp():
    rng = np.random.default_rng(3)
    for n_set, size in ((50, 80), (50, 20), (0, 16)):
        mask = np.zeros(300, bool)
        mask[rng.permutation(300)[:n_set]] = True
        (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=299)
        got = tm.nonzero_static(torch.from_numpy(mask), size, 299)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_occupancy_create_cell_centers_and_blob_scene():
    """bench.py's scene: blob density at the cell centres, packed at 1.0.
    Positions are the same f32 expressions (exact); the blob density sums
    exp() terms, so allclose at 1e-6 relative."""
    from tngp.data.synthetic import make_blob_field as jax_blob
    from tngp.render import occupancy as jocc
    from tngp_torch.data.synthetic import make_blob_field
    from tngp_torch.render import occupancy as tocc

    jg, tg = jocc.create(1, H), tocc.create(1, H, device="cpu")
    assert tuple(tg.density_grid.shape) == jg.density_grid.shape
    assert tuple(tg.bitfield.shape) == jg.bitfield.shape and tg.cascades == 1
    xj = jocc._cells_to_world_cf(jocc._linear_coords(H), 0, 1.0, H, None)
    xt = tocc.cell_centers_cf(0, 1.0, H, device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    dj = np.array(jax_blob(0).density(None, xj))
    dt = make_blob_field(0, device="cpu").density(None, xt).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-6)
    sj, rj = jax_blob(0).sigma_rgb(None, xj[:, :500], xj[:, :500])
    st, rt = make_blob_field(0, device="cpu").sigma_rgb(None, xt[:, :500], xt[:, :500])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tgu.packbits(torch.from_numpy(dj), 1.0).numpy(),
                                  np.asarray(jgu.packbits(jnp.asarray(dj), 1.0)))
