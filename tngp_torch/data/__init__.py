from .provider import NeRFDataset, nerf_matrix_to_ngp, rand_poses
from .rays import full_image_rays, sample_rays
from .synthetic import (
    make_blob_field,
    make_synthetic_dataset,
    make_synthetic_dynamic_dataset,
    make_time_blob_field,
    orbit_poses,
    render_gt_images,
)

__all__ = [
    "NeRFDataset", "nerf_matrix_to_ngp", "rand_poses", "full_image_rays", "sample_rays", "make_blob_field",
    "make_synthetic_dataset", "make_synthetic_dynamic_dataset", "make_time_blob_field",
    "orbit_poses", "render_gt_images",
]
