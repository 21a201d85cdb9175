from .occupancy import (
    GridDraws,
    OccupancyGrid,
    cell_centers_cf,
    create,
    mark_untrained_grid,
    update_density_grid,
    update_density_grid_from_draws,
)
from .renderer import (
    FieldFns,
    RenderConfig,
    dilated_chunk_grid,
    render_rays_eval,
    render_rays_train,
    render_rays_uniform,
    train_sample_budget,
)

__all__ = [
    "GridDraws", "OccupancyGrid", "cell_centers_cf", "create", "mark_untrained_grid",
    "update_density_grid", "update_density_grid_from_draws", "FieldFns", "RenderConfig",
    "dilated_chunk_grid", "render_rays_eval", "render_rays_train", "render_rays_uniform",
    "train_sample_budget",
]
