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
from tngp_torch.data.rays import full_image_rays
from tngp_torch.data.synthetic import orbit_poses
from tngp_torch.ops import march as tm
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


@pytest.mark.parametrize("cascades,dilate", [(1, 1), (1, 3), (2, 2)])
def test_build_dilated_cell_grid_matches(cascades, dilate):
    bound = 1.0 if cascades == 1 else 2.0
    kw = dict(bound=bound, cascades=cascades, grid_size=H, dilate=dilate)
    gj, gt = _both(lambda b: jm.build_dilated_cell_grid(b, **kw),
                   lambda b: tm.build_dilated_cell_grid(b, **kw), _bitfield(2, cascades))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


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
