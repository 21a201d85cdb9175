from .rays import full_image_rays
from .synthetic import make_blob_field, orbit_poses

__all__ = ["full_image_rays", "make_blob_field", "orbit_poses"]
