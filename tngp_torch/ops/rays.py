"""Ray utility ops — the port of `tngp/ops/rays.py`: `near_far_from_aabb`
(slab test, min_near clamp, miss -> +big) and `sph_from_ray` (the
background sphere's coordinates)."""

from __future__ import annotations

import functools
import math

import torch

_BIG = 3.4e38


@functools.lru_cache(maxsize=None)
def _box(aabb: tuple, device: str) -> torch.Tensor:
    """The box as a tensor on `device`, uploaded once: a host-to-device copy
    per call would make the host wait for the stream in every train step."""
    return torch.tensor(aabb, dtype=torch.float32, device=device)



def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb,
                       min_near: float = 0.05):
    """rays_o/rays_d [..., 3], aabb [6] = (xmin, ymin, zmin, xmax, ymax, zmax):
    a tuple of floats, or a float32 tensor on the rays' device (a box
    computed there).  Returns (nears, fars) [...]; rays that miss get
    near = far = 3.4e38."""
    o = rays_o.float()
    d = rays_d.float()
    if isinstance(aabb, torch.Tensor):
        box = aabb
    else:
        box = _box(tuple(float(v) for v in aabb), str(o.device))
    inv_d = 1.0 / d  # +-inf for axis-parallel rays, as IEEE and the CUDA code
    t0 = (box[:3] - o) * inv_d
    t1 = (box[3:] - o) * inv_d
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    near = tmin.amax(dim=-1)
    far = tmax.amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    big = torch.full_like(near, _BIG)
    near = torch.where(miss, big, near)
    far = torch.where(miss, big, far)
    return near.to(rays_o.dtype), far.to(rays_o.dtype)


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Intersect rays with the background sphere ||o + t d|| = radius (the
    larger root) and return [..., 2] (theta, phi) normalised to [-1, 1]
    (y up).  Element-wise f32 throughout: no matrix product, so TF32 never
    enters."""
    o = rays_o.float()
    d = rays_d.float()
    A = (d * d).sum(dim=-1)
    B = (o * d).sum(dim=-1)
    C = (o * o).sum(dim=-1) - radius * radius
    t = (-B + torch.sqrt(torch.clamp(B * B - A * C, min=0.0))) / A
    p = o + t[..., None] * d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, pi)
    phi = torch.atan2(z, x)  # [-pi, pi)
    inv_pi = 1.0 / math.pi
    out = torch.stack([2.0 * theta * inv_pi - 1.0, phi * inv_pi], dim=-1)
    return out.to(rays_o.dtype)
