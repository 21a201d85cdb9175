from .occupancy import OccupancyGrid, cell_centers_cf, create
from .renderer import FieldFns, RenderConfig, dilated_chunk_grid, render_rays_eval

__all__ = [
    "OccupancyGrid", "cell_centers_cf", "create", "FieldFns", "RenderConfig",
    "dilated_chunk_grid", "render_rays_eval",
]
