"""Camera rays — the port of `tngp/data/rays.py` (`full_image_rays`,
`sample_rays`).

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


def _rotate(dirs: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """dirs @ R^T written out elementwise (true f32)."""
    R = pose[:3, :3]
    return torch.stack(
        [dirs[:, 0] * R[r, 0] + dirs[:, 1] * R[r, 1] + dirs[:, 2] * R[r, 2]
         for r in range(3)],
        dim=-1,
    )


def sample_rays(
    pose: torch.Tensor,  # [4, 4] c2w (ngp convention)
    intrinsics: torch.Tensor,  # [4] fx fy cx cy
    H: int,
    W: int,
    N: int,
    *,
    inds: torch.Tensor | None = None,  # [N] explicit flat pixel indices
    generator: torch.Generator | None = None,
    error_map: torch.Tensor | None = None,  # [128*128] sampling weights
    patch_size: int = 1,
):
    """Sample N pixel rays from one camera.  Returns dict with rays_o/rays_d
    [N, 3], inds [N] flat pixel indices (row * W + col) and inds_coarse when
    error_map is given.  Where the JAX function takes a key, this one takes
    the pixel indices themselves (`inds`) or a `generator` on the pose's
    device for the three sampling modes (uniform, patches, error-map
    weighted)."""
    dev = pose.device
    out = {}
    if inds is not None:
        inds = inds.long()
    elif generator is None:
        raise ValueError("sample_rays needs inds or a generator")
    elif patch_size > 1:
        num_patch = N // (patch_size**2)
        px = torch.randint(0, H - patch_size, (num_patch,), generator=generator, device=dev)
        py = torch.randint(0, W - patch_size, (num_patch,), generator=generator, device=dev)
        r = torch.arange(patch_size, device=dev)
        pi, pj = torch.meshgrid(r, r, indexing="ij")
        offs = torch.stack([pi.reshape(-1), pj.reshape(-1)], dim=-1)  # [p^2, 2]
        coords = (torch.stack([px, py], dim=-1)[:, None, :] + offs[None]).reshape(-1, 2)
        inds = coords[:, 0] * W + coords[:, 1]
    elif error_map is None:
        inds = torch.randint(0, H * W, (N,), generator=generator, device=dev)
    else:
        # weighted sample on the 128x128 error grid, with replacement
        cdf = torch.cumsum(torch.clamp(error_map.float(), min=1e-12), dim=0)
        u = torch.rand((3, N), generator=generator, device=dev)
        inds_coarse = torch.clamp(torch.searchsorted(cdf, u[0] * cdf[-1]), 0, 128 * 128 - 1)
        ix, iy = inds_coarse // 128, inds_coarse % 128
        sx, sy = H / 128.0, W / 128.0
        ix = torch.clamp((ix * sx + u[1] * sx).long(), 0, H - 1)
        iy = torch.clamp((iy * sy + u[2] * sy).long(), 0, W - 1)
        inds = ix * W + iy
        out["inds_coarse"] = inds_coarse
    jj = (inds // W).float() + 0.5  # row
    ii = (inds % W).float() + 0.5  # col
    rays_d = _rotate(_pixel_dirs(ii, jj, intrinsics), pose)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    out.update({"rays_o": rays_o, "rays_d": rays_d, "inds": inds})
    return out


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
    rays_d = _rotate(dirs, pose)
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d
