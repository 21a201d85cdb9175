"""Port parity: ray sampling, the uniform (grid-free) renderer, inverse-CDF
sampling and the synthetic dataset of `tngp_torch` against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tngp.data.rays import full_image_rays as jax_full_image_rays
from tngp.data.synthetic import make_blob_field as jax_blob_field
from tngp.data.synthetic import orbit_poses
from tngp.data.synthetic import render_gt_images as jax_render_gt_images
from tngp.ops.sampling import sample_pdf as jax_sample_pdf
from tngp.render import RenderConfig as JaxRenderConfig
from tngp.render import render_rays_uniform as jax_render_rays_uniform
from tngp_torch.data import make_blob_field, make_synthetic_dataset, sample_rays
from tngp_torch.ops.sampling import sample_pdf
from tngp_torch.render import RenderConfig, render_rays_uniform

H, W = 48, 40
INTR = np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)


def test_sample_rays_with_explicit_pixels_matches_full_image_rays():
    """true f32 ray geometry: rays_o exact, rays_d to 1e-6 (the JAX side
    rotates with a matmul, the port elementwise)."""
    pose = orbit_poses(5)[2]
    inds = np.random.default_rng(0).integers(0, H * W, 300)
    o_all, d_all = jax_full_image_rays(jnp.asarray(pose), jnp.asarray(INTR), H, W)
    r = sample_rays(torch.from_numpy(pose), torch.from_numpy(INTR), H, W, 300,
                    inds=torch.from_numpy(inds))
    np.testing.assert_array_equal(r["inds"].numpy(), inds)
    np.testing.assert_array_equal(r["rays_o"].numpy(), np.asarray(o_all)[inds])
    np.testing.assert_allclose(r["rays_d"].numpy(), np.asarray(d_all)[inds], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(r["rays_d"].numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["uniform", "patch", "error_map"])
def test_sample_rays_modes_draw_valid_pixels(mode):
    """The three sampling modes with a generator: indices in range, patches
    contiguous, error-map samples concentrated where the map is."""
    pose = torch.from_numpy(orbit_poses(3)[1])
    gen = torch.Generator().manual_seed(1)
    kw = {}
    if mode == "patch":
        kw["patch_size"] = 4
    if mode == "error_map":
        em = torch.full((128 * 128,), 1e-9)
        em[:128 * 16] = 1.0  # the top eighth of the coarse grid
        kw["error_map"] = em
    r = sample_rays(pose, torch.from_numpy(INTR), H, W, 256, generator=gen, **kw)
    inds = r["inds"].numpy()
    assert inds.shape == (256,) and inds.min() >= 0 and inds.max() < H * W
    assert r["rays_d"].shape == (256, 3) and len(np.unique(inds)) > 100
    if mode == "patch":
        first = inds[:16].reshape(4, 4)
        assert (np.diff(first, axis=1) == 1).all() and (np.diff(first, axis=0) == W).all()
    if mode == "error_map":
        assert (inds // W < H / 8 + 1).all() and r["inds_coarse"].max() < 128 * 16
    with pytest.raises(ValueError):
        sample_rays(pose, torch.from_numpy(INTR), H, W, 8)


def test_sample_pdf_det_matches_jax_and_explicit_u_matches_oracle():
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0, 4, (20, 33)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (20, 32)).astype(np.float32)
    weights[:, 5:12] = 0.0
    det_want = jax_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det=True)
    det_got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 24, det=True)
    np.testing.assert_allclose(det_got.numpy(), np.asarray(det_want), rtol=1e-5, atol=1e-5)
    # explicit uniforms: the JAX function draws its own from a key, so the
    # port is held to a scalar numpy oracle of the inverse CDF
    u = rng.uniform(0, 1, (20, 24)).astype(np.float32)
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 24, u=torch.from_numpy(u))
    cdf = np.concatenate([np.zeros((20, 1)), np.cumsum((weights + 1e-5) / (weights + 1e-5).sum(
        -1, keepdims=True), -1)], -1)
    for b in range(20):
        k = np.searchsorted(cdf[b], u[b], side="right")
        lo, hi = np.maximum(k - 1, 0), np.minimum(k, 32)
        den = np.where(cdf[b][hi] - cdf[b][lo] < 1e-5, 1.0, cdf[b][hi] - cdf[b][lo])
        want = bins[b][lo] + (u[b] - cdf[b][lo]) / den * (bins[b][hi] - bins[b][lo])
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("upsample", [0, 16])
def test_render_rays_uniform_matches_jax_on_the_blob_field(upsample):
    """64 rays through the analytic field, deterministic (no perturbation):
    f32 quadrature in both, 1e-5."""
    pose = orbit_poses(4)[1]
    o, d = jax_full_image_rays(jnp.asarray(pose), jnp.asarray(INTR), H, W)
    sel = np.random.default_rng(1).integers(0, H * W, 64)
    o, d = np.asarray(o)[sel], np.asarray(d)[sel]
    kw = dict(bound=1.0, min_near=0.05)
    want = jax_render_rays_uniform(jax_blob_field(0), None, jnp.asarray(o), jnp.asarray(d),
                                   JaxRenderConfig(**kw), num_steps=48, upsample_steps=upsample)
    got = render_rays_uniform(make_blob_field(0, device="cpu"), None, torch.from_numpy(o),
                              torch.from_numpy(d), RenderConfig(**kw), num_steps=48,
                              upsample_steps=upsample)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert 0.1 < float(got["weights_sum"].mean()) < 1.0


def test_make_synthetic_dataset_matches_jax_ground_truth():
    ds = make_synthetic_dataset(n_frames=2, H=16, W=16, seed=0, num_steps=64, device="cpu")
    want = jax_render_gt_images(jax_blob_field(0), ds.poses, ds.intrinsics, 16, 16, 1.0, 64)
    assert ds.images.shape == (2, 16, 16, 3) and ds.images.dtype == np.float32
    assert ds.num_frames == 2
    np.testing.assert_array_equal(ds.intrinsics, np.array([14.4, 14.4, 8.0, 8.0], np.float32))
    np.testing.assert_array_equal(ds.poses, orbit_poses(2))
    np.testing.assert_allclose(ds.images, want, rtol=0, atol=1e-5)
