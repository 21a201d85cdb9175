"""Synthetic analytic scene — the port of `tngp/data/synthetic.py`
`make_blob_field` (gaussian blobs with per-blob albedo; the same numpy draws
as the JAX package for one seed), `orbit_poses`, `render_gt_images`,
`make_synthetic_dataset`, the hard benchmark scene (`make_hard_field`,
`make_hard_dataset`: sharp superellipsoids with high-frequency textures),
and the dynamic scene of D-NeRF (`make_time_blob_field`,
`make_synthetic_dynamic_dataset`).  Ground truth
comes from dense uniform quadrature through the analytic field, independent
of the occupancy-grid march."""

from __future__ import annotations

import numpy as np
import torch

from ..render.renderer import FieldFns, RenderConfig, render_rays_uniform
from .provider import NeRFDataset
from .rays import full_image_rays


def make_blob_field(seed: int = 0, n_blobs: int = 6, sigma_scale: float = 60.0,
                    device="cuda") -> FieldFns:
    rng = np.random.default_rng(seed)
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (n_blobs, 3)), dtype=torch.float32,
                              device=device)
    radii = torch.as_tensor(rng.uniform(0.1, 0.25, (n_blobs,)), dtype=torch.float32,
                            device=device)
    colors = torch.as_tensor(rng.uniform(0.2, 1.0, (n_blobs, 3)), dtype=torch.float32,
                             device=device)

    def _blob_w(x_cf):
        # [3, B] -> per-blob gaussian weights [n, B]
        d2 = torch.sum((x_cf[:, None, :] - centers.T[:, :, None]) ** 2, dim=0)
        return torch.exp(-d2 / (2 * radii[:, None] ** 2))

    def density(params, x_cf):
        return sigma_scale * torch.sum(_blob_w(x_cf), dim=0)

    def sigma_rgb(params, x_cf, d_cf):
        w = _blob_w(x_cf)
        sig = sigma_scale * torch.sum(w, dim=0)
        # elementwise blend: no TF32 matmul on the colours
        rgb_cf = (colors.T[:, :, None] * w[None]).sum(dim=1) / (
            torch.sum(w, dim=0, keepdim=True) + 1e-6
        )
        return sig, torch.clamp(rgb_cf, 0.0, 1.0)

    return FieldFns(sigma_rgb=sigma_rgb, density=density)


def orbit_poses(n: int, radius: float = 2.2, elevation: float = 0.45) -> np.ndarray:
    """Deterministic ring of cameras looking at the origin (ngp convention:
    the camera looks down +z in its own frame)."""
    poses = []
    for k in range(n):
        phi = 2 * np.pi * k / n
        theta = np.pi / 2 - elevation * np.sin(2 * phi + 0.7)
        c = radius * np.array(
            [np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)]
        )
        forward = -c / np.linalg.norm(c)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, forward)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, up2, forward], axis=-1)
        pose[:3, 3] = c
        poses.append(pose)
    return np.stack(poses)


@torch.no_grad()
def render_gt_images(
    field: FieldFns,
    poses: np.ndarray,
    intrinsics: np.ndarray,
    H: int,
    W: int,
    bound: float = 1.0,
    num_steps: int = 512,
    chunk: int = 8192,
    device="cuda",
) -> np.ndarray:
    """[B, H, W, 3] float32 views of `field` by uniform quadrature
    (`render_rays_uniform`, no upsampling), rendered on `device`."""
    cfg = RenderConfig(bound=bound, min_near=0.05)
    images = []
    for pose in poses:
        o, d = full_image_rays(pose, intrinsics, H, W, device=device)
        pieces = [
            render_rays_uniform(field, None, o[s:s + chunk], d[s:s + chunk], cfg,
                                num_steps=num_steps, upsample_steps=0)["image"]
            for s in range(0, o.shape[0], chunk)
        ]
        images.append(torch.cat(pieces).reshape(H, W, 3))
    return torch.stack(images).cpu().numpy()


def make_synthetic_dataset(
    n_frames: int = 20,
    H: int = 128,
    W: int = 128,
    seed: int = 0,
    bound: float = 1.0,
    num_steps: int = 512,
    device="cuda",
) -> NeRFDataset:
    """`n_frames` orbit views of the blob scene of `seed`, rendered on
    `device`; the dataset itself is host numpy, as the JAX package's."""
    field = make_blob_field(seed, device=device)
    poses = orbit_poses(n_frames)
    focal = 0.9 * W
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    images = render_gt_images(field, poses, intrinsics, H, W, bound, num_steps,
                              device=device)
    return NeRFDataset(
        poses=poses, intrinsics=intrinsics, H=H, W=W, images=images.astype(np.float32)
    )


def make_hard_field(seed: int = 0, n_shapes: int = 10, sharpness: float = 80.0,
                    device="cuda") -> FieldFns:
    """The hard benchmark scene on `device`: solid sharp-surface shapes
    (superellipsoids, exponent 2-6, from spheres to rounded boxes) with
    high-frequency procedural textures, from the JAX package's numpy draws
    for `seed`; sharp boundaries stress the march, fine texture the fine
    grid levels."""
    rng = np.random.default_rng(seed)

    def draw(*args):
        return torch.as_tensor(rng.uniform(*args), dtype=torch.float32, device=device)

    centers = draw(-0.55, 0.55, (n_shapes, 3))
    radii = draw(0.08, 0.22, (n_shapes,))
    base_col = draw(0.15, 0.95, (n_shapes, 3))
    tex_freq = draw(12.0, 42.0, (n_shapes, 3))
    tex_phase = draw(0, 2 * np.pi, (n_shapes, 3))
    powr = draw(2.0, 6.0, (n_shapes,))

    def _occupancy(x_cf):
        """[3, B] -> per-shape soft indicator [n, B] with a sharp falloff."""
        d = torch.abs(x_cf[:, None, :] - centers.T[:, :, None])  # [3, n, B]
        dist = torch.sum(d ** powr[None, :, None], dim=0) ** (1.0 / powr[:, None])
        return torch.sigmoid(sharpness * (radii[:, None] - dist) / radii[:, None])

    def density(params, x_cf):
        return 250.0 * torch.sum(_occupancy(x_cf), dim=0)

    def sigma_rgb(params, x_cf, d_cf):
        occ = _occupancy(x_cf)  # [n, B]
        sig = 250.0 * torch.sum(occ, dim=0)
        ph = tex_freq.T[:, :, None] * x_cf[:, None, :] + tex_phase.T[:, :, None]
        tex = 0.62 + 0.38 * torch.prod(torch.sin(ph), dim=0)  # [n, B]
        cols = base_col.T[:, :, None] * tex[None, :, :]  # [3, n, B]
        wsum = torch.sum(occ, dim=0, keepdim=True) + 1e-6
        # elementwise blend: no TF32 matmul on the colours
        rgb_cf = (cols * occ[None]).sum(dim=1) / wsum
        return sig, torch.clamp(rgb_cf, 0.0, 1.0)

    return FieldFns(sigma_rgb=sigma_rgb, density=density)


def make_hard_dataset(
    n_frames: int = 100,
    H: int = 256,
    W: int = 256,
    seed: int = 0,
    bound: float = 1.0,
    num_steps: int = 1024,
    device="cuda",
) -> NeRFDataset:
    """`n_frames` orbit views of the hard scene, rendered on `device` (the
    JAX package's 100-view 256^2 quality benchmark by default; the tracked
    `.cache/hard_256.npz` holds that render)."""
    field = make_hard_field(seed, device=device)
    poses = orbit_poses(n_frames)
    focal = 0.9 * W
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    images = render_gt_images(field, poses, intrinsics, H, W, bound, num_steps,
                              device=device)
    return NeRFDataset(
        poses=poses, intrinsics=intrinsics, H=H, W=W, images=images.astype(np.float32)
    )


def make_time_blob_field(t: float, seed: int = 0, n_blobs: int = 4, device="cuda") -> FieldFns:
    """Analytic dynamic scene: the blobs of `seed` rotated about the y axis
    by 0.6 t radians (the field is evaluated at rot @ x)."""
    base = make_blob_field(seed, n_blobs, device=device)
    ang = 0.6 * float(t)
    c, s = np.cos(ang), np.sin(ang)
    rot = torch.tensor([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=torch.float32, device=device)

    def rotate(x_cf):
        # written out: no TF32 matmul on the positions
        return rot[:, 0:1] * x_cf[0] + rot[:, 1:2] * x_cf[1] + rot[:, 2:3] * x_cf[2]

    def density(params, x_cf):
        return base.density(params, rotate(x_cf))

    def sigma_rgb(params, x_cf, d_cf):
        return base.sigma_rgb(params, rotate(x_cf), d_cf)

    return FieldFns(sigma_rgb=sigma_rgb, density=density)


def make_synthetic_dynamic_dataset(
    n_frames: int = 12,
    H: int = 64,
    W: int = 64,
    seed: int = 0,
    bound: float = 1.0,
    num_steps: int = 256,
    device="cuda",
) -> NeRFDataset:
    """Orbit views of the dynamic blob scene, frame i at time
    linspace(0, 1, n_frames)[i], rendered on `device`; `times` [B] float32."""
    poses = orbit_poses(n_frames)
    times = np.linspace(0.0, 1.0, n_frames).astype(np.float32)
    focal = 0.9 * W
    intrinsics = np.array([focal, focal, W / 2, H / 2], np.float32)
    images = [
        render_gt_images(make_time_blob_field(float(t), seed, device=device), pose[None],
                         intrinsics, H, W, bound, num_steps, device=device)[0]
        for pose, t in zip(poses, times)
    ]
    return NeRFDataset(
        poses=poses, intrinsics=intrinsics, H=H, W=W,
        images=np.stack(images).astype(np.float32), times=times,
    )
