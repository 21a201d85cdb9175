"""Synthetic analytic scene — the port of `tngp/data/synthetic.py`
`make_blob_field` (gaussian blobs with per-blob albedo; the same numpy draws
as the JAX package for one seed), `orbit_poses`, `render_gt_images` and
`make_synthetic_dataset`.  Ground truth comes from dense uniform quadrature
through the analytic field, independent of the occupancy-grid march."""

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
