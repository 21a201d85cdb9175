"""Plain tensor ops of the render and training paths (counterparts of `tngp/ops/`).

The march, compaction and compositing names of the render paths are
exported here, as `tngp.ops` exports them; the other ops are imported from
their modules."""

from .compaction import (
    Compaction,
    StreamCompaction,
    compact_mask,
    compact_mask_hier,
    expand_to_slab,
    gather_cf,
    ray_in_budget_from_counts,
)
from .composite import (
    composite_rays,
    composite_rays_cf,
    composite_rays_flat,
    composite_stream,
    composite_weights,
)
from .march import (
    ChunkedMarch,
    MarchResult,
    StreamMarch,
    build_coarse_occupancy,
    build_dilated_cell_grid,
    grid_cell_index,
    ladder_samples,
    march_rays,
    march_rays_chunked,
    march_rays_dense,
    march_rays_stream,
    mip_level,
)

__all__ = [
    "Compaction", "StreamCompaction", "compact_mask", "compact_mask_hier", "expand_to_slab",
    "gather_cf", "ray_in_budget_from_counts",
    "composite_rays", "composite_rays_cf", "composite_rays_flat", "composite_stream",
    "composite_weights",
    "ChunkedMarch", "MarchResult", "StreamMarch", "build_coarse_occupancy",
    "build_dilated_cell_grid", "grid_cell_index", "ladder_samples", "march_rays",
    "march_rays_chunked", "march_rays_dense", "march_rays_stream", "mip_level",
]
