"""Occupancy grid container — the port of `tngp/render/occupancy.py`
`create`, plus the cell-centre positions its updates query.  Cells are in
linear order (cell = (ix*H + iy)*H + iz).  Grid updates come with training.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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


def cell_centers_cf(cas: int, bound: float, grid_size: int, device="cuda") -> torch.Tensor:
    """[3, H^3] world positions of every cell of cascade `cas`, un-jittered
    (`_linear_coords` + `_cells_to_world_cf` of the JAX package)."""
    H = grid_size
    r = torch.arange(H, dtype=torch.int64, device=device)
    ix, iy, iz = torch.meshgrid(r, r, r, indexing="ij")
    coords = torch.stack([ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)])  # [3, H^3]
    cas_bound = min(2.0**cas, bound)
    half = cas_bound / H
    xyz = 2.0 * coords.float() / (H - 1) - 1.0
    return xyz * (cas_bound - half)
