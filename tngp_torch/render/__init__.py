from .frame_eval import FrameRenderer
from .occupancy import (
    GridDraws,
    OccupancyGrid,
    TimeOccupancyGrid,
    TimeSliceDraws,
    cell_centers_cf,
    create,
    create_time,
    mark_untrained_grid,
    time_slice_index,
    update_density_grid,
    update_density_grid_from_draws,
    update_time_density_grid,
    update_time_density_grid_from_draws,
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
    "FrameRenderer",
    "GridDraws", "OccupancyGrid", "TimeOccupancyGrid", "TimeSliceDraws", "cell_centers_cf",
    "create", "create_time", "mark_untrained_grid", "time_slice_index",
    "update_density_grid", "update_density_grid_from_draws", "update_time_density_grid",
    "update_time_density_grid_from_draws", "FieldFns", "RenderConfig",
    "dilated_chunk_grid", "render_rays_eval", "render_rays_train", "render_rays_uniform",
    "train_sample_budget",
]
