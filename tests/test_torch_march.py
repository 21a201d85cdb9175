"""Port parity: the eval march of `tngp_torch` against the JAX package —
`march_rays_chunked` (integer outputs exact, as the contract at
tngp/ops/march.py:532-538 requires), `ladder_samples`,
`build_dilated_cell_grid`, `near_far_from_aabb`, `bitfield_probe`,
`packbits`, the static-size nonzero, `full_image_rays`, and the occupancy
container with bench.py's blob scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data.rays import full_image_rays as jax_full_image_rays
from tngp.ops import grid_utils as jgu
from tngp.ops import march as jm
from tngp.ops.rays import near_far_from_aabb as jax_near_far
from tngp_torch.data.rays import full_image_rays
from tngp_torch.data.synthetic import orbit_poses
from tngp_torch.ops import grid_utils as tgu
from tngp_torch.ops import march as tm
from tngp_torch.ops.rays import near_far_from_aabb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H = 32
AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -2.5]) + rng.normal(0, 0.05, size=(n, 3))
    target = rng.uniform(-0.6, 0.6, size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[0] = [1.0, 0.0, 0.0]  # misses the box (near = far = big)
    return o, d


def _bitfield(seed, cascades=1):
    rng = np.random.default_rng(seed)
    ax = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    occ = ((gx**2 + gy**2 + gz**2) < 0.55**2) | (rng.uniform(size=gx.shape) < 0.02)
    occ = np.tile(occ.reshape(-1), cascades).astype(np.float32)
    return np.asarray(jgu.packbits(jnp.asarray(occ), 0.5))


def _both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    t = fn_t(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    return j, t


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


@pytest.mark.parametrize("cascades,dilate", [(1, 1), (1, 3), (2, 2)])
def test_build_dilated_cell_grid_matches(cascades, dilate):
    bound = 1.0 if cascades == 1 else 2.0
    kw = dict(bound=bound, cascades=cascades, grid_size=H, dilate=dilate)
    gj, gt = _both(lambda b: jm.build_dilated_cell_grid(b, **kw),
                   lambda b: tm.build_dilated_cell_grid(b, **kw), _bitfield(2, cascades))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_nonzero_static_matches_jnp():
    rng = np.random.default_rng(3)
    for n_set, size in ((50, 80), (50, 20), (0, 16)):
        mask = np.zeros(300, bool)
        mask[rng.permutation(300)[:n_set]] = True
        (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=299)
        got = tm.nonzero_static(torch.from_numpy(mask), size, 299)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def test_full_image_rays_and_orbit_poses():
    """Pose product written elementwise in true f32: equal to the JAX f32
    matmul to rounding of a 3-term sum (atol 2e-7 on unit directions)."""
    from tngp.data.synthetic import orbit_poses as jax_orbit_poses

    poses = orbit_poses(4, radius=2.35, elevation=0.3)
    np.testing.assert_array_equal(poses, jax_orbit_poses(4, radius=2.35, elevation=0.3))
    intr = np.array([0.9 * 40, 0.9 * 40, 20, 15], np.float32)
    oj, dj = jax_full_image_rays(jnp.asarray(poses[1]), jnp.asarray(intr), 30, 40)
    ot, dt = full_image_rays(poses[1], intr, 30, 40, device="cpu")
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=2e-7)


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
