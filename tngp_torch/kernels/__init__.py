"""Hand-written CUDA kernels and their wrappers (counterparts of the Pallas
kernels in `tngp/kernels/`).  `KERNELS` lists every kernel with its source,
the TPU kernel it replaces and its launch count."""

from ._lib import KERNELS, load_all, plain_versions, reset_launch_counts
from .int_mul import int_mul_hash
from .march import march_rays_chunked_cuda, march_rays_chunked_plain
from .scatter import scatter_add, scatter_set_flat
from .window_encoder import (
    bin_dest,
    window_encode_binned,
    window_encode_bwd,
    window_encode_dx,
    window_encode_fwd,
)

__all__ = [
    "KERNELS", "load_all", "plain_versions", "reset_launch_counts", "int_mul_hash",
    "march_rays_chunked_cuda", "march_rays_chunked_plain",
    "scatter_add", "scatter_set_flat",
    "bin_dest", "window_encode_binned", "window_encode_bwd",
    "window_encode_dx", "window_encode_fwd",
]
