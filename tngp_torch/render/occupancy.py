"""Occupancy (density) grid maintenance — the port of
`tngp/render/occupancy.py`: `create`, `mark_untrained_grid`,
`update_density_grid` (`full`, and the partial modes `resample` and `slab`)
and the occupied-cell inverse-CDF sampler.  Cells are in linear order
(cell = (ix*H + iy)*H + iz).

The random draws of an update (`GridDraws`) are separate from the update
itself (`update_density_grid_from_draws`), so that a test can feed this
package and the JAX package the same ones.

Duplicate cells in the `resample` write.  `rand_idx ++ occ_idx` may name a
cell twice; both values are fresh densities of that cell under different
jitter, and which one is kept is unspecified (as XLA's set-scatter leaves
it, and `index_put_` on CUDA).  The running `max` with the decayed grid
follows either way.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.grid_utils import packbits


@dataclass
class OccupancyGrid:
    density_grid: torch.Tensor  # [CAS, H^3] float32; -1 marks untrained cells
    bitfield: torch.Tensor  # [CAS * H^3 // 8] uint8
    mean_density: torch.Tensor  # scalar float32
    iter_density: torch.Tensor  # scalar int64

    @property
    def cascades(self) -> int:
        return self.density_grid.shape[0]


def create(cascades: int, grid_size: int, device="cuda") -> OccupancyGrid:
    H3 = grid_size**3
    return OccupancyGrid(
        density_grid=torch.zeros((cascades, H3), dtype=torch.float32, device=device),
        bitfield=torch.zeros((cascades * H3 // 8,), dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int64, device=device),
    )


def _linear_coords_cf(grid_size: int, device) -> torch.Tensor:
    """[3, H^3] int64 cell coords in linear order (ix major, iz fastest)."""
    r = torch.arange(grid_size, dtype=torch.int64, device=device)
    ix, iy, iz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)])


def _cells_to_world_cf(coords_cf, cas: int, bound: float, grid_size: int, jitter=None):
    """Cell coords [3, N] -> (jittered) world positions [3, N]."""
    cas_bound = min(2.0**cas, bound)
    half = cas_bound / grid_size
    xyz = 2.0 * coords_cf.float() / (grid_size - 1) - 1.0
    xyz = xyz * (cas_bound - half)
    if jitter is not None:
        xyz = xyz + jitter * half
    return xyz


def cell_centers_cf(cas: int, bound: float, grid_size: int, device="cuda") -> torch.Tensor:
    """[3, H^3] world positions of every cell of cascade `cas`, un-jittered."""
    return _cells_to_world_cf(_linear_coords_cf(grid_size, device), cas, bound, grid_size)


def _idx_coords_cf(idx: torch.Tensor, H: int) -> torch.Tensor:
    return torch.stack([idx // (H * H), (idx // H) % H, idx % H])


def _chunked_density(density_fn, params, xyz_cf: torch.Tensor, chunk: int) -> torch.Tensor:
    """Density over [3, N] points in chunks of `chunk` (bounds the encoder's
    intermediates)."""
    N = xyz_cf.shape[1]
    if N <= chunk:
        return density_fn(params, xyz_cf).reshape(-1)
    return torch.cat([
        density_fn(params, xyz_cf[:, s:s + chunk]).reshape(-1) for s in range(0, N, chunk)
    ])


def _occupied_rank_descend(occ: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the first cell whose running occupied count >= u, for each
    u: `searchsorted(cumsum(occ), u, side="left")`, clipped.  The JAX
    package computes the same indices by a 128-way hierarchical descent
    (built for the TPU's gather); counts are exact in f32 below 2^24."""
    cdf = torch.cumsum(occ.float(), dim=0)
    return torch.clamp(torch.searchsorted(cdf, u.contiguous()), 0, occ.shape[0] - 1)


def _sample_occupied_cells(occ: torch.Tensor, u01: torch.Tensor):
    """Uniform sample over the occupied set from uniforms `u01` in [0, 1).
    Returns (idx [n] int64, total occupied count as an f32 scalar)."""
    total = occ.float().sum()
    u = u01 * torch.clamp(total, min=1.0)
    return _occupied_rank_descend(occ, u), total


class GridDraws(NamedTuple):
    """The random numbers of one cascade's update.  `jitter` is [3, n] in
    [-1, 1) with n = H^3 (full), H^3/2 (slab) or 2 * (H^3 // 4) (resample);
    `rand_idx` [H^3 // 4] cell indices and `u01` [H^3 // 4] uniforms are
    read by `resample` only."""

    jitter: torch.Tensor
    rand_idx: Optional[torch.Tensor] = None
    u01: Optional[torch.Tensor] = None


def draw_grid_update(cascades: int, grid_size: int, full: bool, partial_mode: str,
                     generator: torch.Generator, device) -> list[GridDraws]:
    H3 = grid_size**3

    def jit(n):
        return torch.rand((3, n), generator=generator, device=device) * 2.0 - 1.0

    draws = []
    for _ in range(cascades):
        if full:
            draws.append(GridDraws(jit(H3)))
        elif partial_mode == "slab":
            draws.append(GridDraws(jit(H3 // 2)))
        else:
            n = H3 // 4
            draws.append(GridDraws(
                jit(2 * n),
                torch.randint(0, H3, (n,), generator=generator, device=device),
                torch.rand((n,), generator=generator, device=device),
            ))
    return draws


@torch.no_grad()
def update_density_grid_from_draws(
    state: OccupancyGrid,
    params,
    draws: list[GridDraws],
    *,
    density_fn: Callable,  # (params, x_cf [3, N]) -> sigma [N]
    bound: float,
    grid_size: int,
    density_thresh: float,
    full: bool,
    decay: float = 0.95,
    density_scale: float = 1.0,
    chunk: int = 2**17,
    partial_mode: str = "resample",
) -> OccupancyGrid:
    """One density-grid update with the given draws (one per cascade): query
    the field at jittered cell positions, keep `max(decayed old, new)` where
    both are known, recompute the mean density and the bitfield at
    `min(mean_density, density_thresh)`.  Returns a new grid state."""
    cascades, H3 = state.density_grid.shape
    H = grid_size
    dev = state.density_grid.device
    tmp = torch.full_like(state.density_grid, -1.0)
    eff_decay = decay

    def query(coords_cf, cas, jitter):
        xyz_cf = _cells_to_world_cf(coords_cf, cas, bound, H, jitter)
        return _chunked_density(density_fn, params, xyz_cf, chunk).float() * density_scale

    if full:
        coords = _linear_coords_cf(H, dev)
        for cas in range(cascades):
            tmp[cas] = query(coords, cas, draws[cas].jitter)
    elif partial_mode == "slab":
        # rotating contiguous half-grid sweep: every cell refreshed every 2
        # partial updates, decay^2 per refresh
        N2 = H3 // 2
        eff_decay = decay * decay
        for cas in range(cascades):
            off = (state.iter_density % 2) * N2
            idx = (off + torch.arange(N2, device=dev)) % H3
            tmp[cas, idx] = query(_idx_coords_cf(idx, H), cas, draws[cas].jitter)
    elif partial_mode == "resample":
        for cas in range(cascades):
            rand_idx = draws[cas].rand_idx.long()
            occ = state.density_grid[cas] > 0
            occ_idx, total = _sample_occupied_cells(occ, draws[cas].u01)
            occ_idx = torch.where(total > 0, occ_idx, rand_idx)
            idx = torch.cat([rand_idx, occ_idx])  # [2N], may repeat a cell
            tmp[cas, idx] = query(_idx_coords_cf(idx, H), cas, draws[cas].jitter)
    else:
        raise ValueError(f"unknown partial_mode {partial_mode!r}")

    valid = (state.density_grid >= 0) & (tmp >= 0)
    grid = torch.where(valid, torch.maximum(state.density_grid * eff_decay, tmp),
                       state.density_grid)
    mean_density = torch.clamp(grid, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyGrid(
        density_grid=grid,
        bitfield=packbits(grid.reshape(-1), thresh),
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
    )


def update_density_grid(state: OccupancyGrid, params, generator: torch.Generator, *,
                        grid_size: int, full: bool, partial_mode: str = "resample",
                        **kw) -> OccupancyGrid:
    """`update_density_grid_from_draws` with draws from `generator` (which
    lives on the grid's device).  Where the JAX function takes a key, this
    one takes the generator."""
    draws = draw_grid_update(state.cascades, grid_size, full, partial_mode, generator,
                             state.density_grid.device)
    return update_density_grid_from_draws(state, params, draws, grid_size=grid_size,
                                          full=full, partial_mode=partial_mode, **kw)


@torch.no_grad()
def mark_untrained_grid(state: OccupancyGrid, poses: torch.Tensor,
                        intrinsics: torch.Tensor, *, bound: float,
                        grid_size: int) -> OccupancyGrid:
    """Mark cells that no training camera sees as -1.  poses [B, 4, 4] c2w,
    intrinsics [4] = fx, fy, cx, cy.  The camera transform is written out
    componentwise (true f32)."""
    cascades, H3 = state.density_grid.shape
    dev = state.density_grid.device
    poses = poses.float()
    fx, fy, cx, cy = (intrinsics[k].float() for k in range(4))
    world = 2.0 * _linear_coords_cf(grid_size, dev).float() / (grid_size - 1) - 1.0  # [3, H^3]
    grid = state.density_grid.clone()
    chunk = 2**17
    for cas in range(cascades):
        cas_bound = min(2.0**cas, bound)
        half = cas_bound / grid_size
        pts = world * (cas_bound - half)
        counts = []
        for s in range(0, H3, chunk):
            p = pts[:, s:s + chunk]
            # world -> cam: (p - t) @ R
            rel = [p[d][None, :] - poses[:, d, 3][:, None] for d in range(3)]  # 3 x [B, n]
            cam = [
                sum(rel[j] * poses[:, j, k][:, None] for j in range(3)) for k in range(3)
            ]
            mask_z = cam[2] > 0
            mask_x = cam[0].abs() < cx / fx * cam[2] + half * 2
            mask_y = cam[1].abs() < cy / fy * cam[2] + half * 2
            counts.append((mask_z & mask_x & mask_y).sum(dim=0))
        count = torch.cat(counts)
        grid[cas] = torch.where(count == 0, torch.full_like(grid[cas], -1.0), grid[cas])
    return replace(state, density_grid=grid)
