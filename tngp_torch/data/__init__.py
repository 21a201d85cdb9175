from .provider import NeRFDataset
from .rays import full_image_rays, sample_rays
from .synthetic import make_blob_field, make_synthetic_dataset, orbit_poses, render_gt_images

__all__ = [
    "NeRFDataset", "full_image_rays", "sample_rays", "make_blob_field",
    "make_synthetic_dataset", "orbit_poses", "render_gt_images",
]
