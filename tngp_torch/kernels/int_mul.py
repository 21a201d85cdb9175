"""Wrapping int32 hash products `(x * P1) ^ (x * P2)` — the port of the
inline Pallas kernel of `scripts/check_device_parity.py` `int_mul_probe`,
which checks on the device that the window encoder's spatial hash wraps
mod 2^32.  The CUDA kernel is `tngp_torch/csrc/int_mul_probe.cu`."""

from __future__ import annotations

import torch

from ..ops.window_table import P1, P2
from . import _lib

KERNEL = _lib.register(
    "int_mul_probe", "int_mul_probe.cu", "scripts/check_device_parity.py:62",
    "tngp_int_mul_probe",
)


def int_mul_hash_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: int64 products masked to 32 bits, then the bits as
    int32.  x int32 (any shape) -> int32 of the same shape."""
    x64 = x.long()
    h = ((x64 * P1) ^ (x64 * P2)) & 0xFFFFFFFF
    return (h - ((h >> 31) << 32)).to(torch.int32)


def int_mul_hash(x: torch.Tensor) -> torch.Tensor:
    """`(x * P1) ^ (x * P2)` with 32-bit wrapping products (see
    `int_mul_hash_plain`).  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if _lib.use_plain(x):
        return int_mul_hash_plain(x)
    _lib.check(x, "x", torch.int32, tuple(x.shape))
    out = torch.empty_like(x)
    _lib.launch(KERNEL, x.device, x.data_ptr(), out.data_ptr(),
                x.numel())
    return out
