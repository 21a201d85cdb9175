"""Hand-written CUDA kernels and their wrappers (counterparts of the Pallas
kernels in `tngp/kernels/`).  `KERNELS` lists every kernel with its source,
the TPU kernel it replaces and its launch count."""

from ._lib import KERNELS, load_all, plain_versions, reset_launch_counts
from .scatter import scatter_add
from .window_encoder import (
    bin_dest,
    bin_ranks,
    window_encode_binned,
    window_encode_bwd,
    window_encode_fwd,
)

__all__ = [
    "KERNELS", "load_all", "plain_versions", "reset_launch_counts", "scatter_add",
    "bin_dest", "bin_ranks", "window_encode_binned", "window_encode_bwd",
    "window_encode_fwd",
]
