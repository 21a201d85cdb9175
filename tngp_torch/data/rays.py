"""Camera rays — the port of `tngp/data/rays.py` `full_image_rays`.

Ray geometry stays true f32: the 3x3 rotation is written out elementwise,
so no TF32 matmul can touch it (a 0.3% ray-direction error cost ~8 dB on
the hard scene in the JAX package's history).
"""

from __future__ import annotations

import torch


def _pixel_dirs(i, j, intrinsics):
    fx, fy, cx, cy = (intrinsics[k] for k in range(4))
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return dirs / torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))


def full_image_rays(pose, intrinsics, H: int, W: int, device="cuda"):
    """pose [4, 4] camera-to-world (ngp convention), intrinsics [4] = fx fy
    cx cy -> rays_o, rays_d [H*W, 3] in row-major pixel order."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device) + 0.5,
        torch.arange(W, dtype=torch.float32, device=device) + 0.5,
        indexing="ij",
    )
    dirs = _pixel_dirs(ii.reshape(-1), jj.reshape(-1), intr)  # [HW, 3]
    R = pose[:3, :3]
    rays_d = torch.stack(
        [dirs[:, 0] * R[r, 0] + dirs[:, 1] * R[r, 1] + dirs[:, 2] * R[r, 2]
         for r in range(3)],
        dim=-1,
    )
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d
