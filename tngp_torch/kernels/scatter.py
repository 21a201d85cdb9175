"""Scatter-add `out[idx[j], :] += vals[j, :]` in f32 — the port of
`tngp/kernels/scatter.py` `scatter_add`.

Its callers: the payload sort around the window encoder and, in training,
the cotangent sort of its backward (unique indices,
`kernels/window_encoder.py`), the per-ray reduction of the stream compositor
(nondecreasing indices, `ops/composite.py`) and the eval render's per-round
state update.  It is not differentiable by itself: callers that need a
gradient wrap it in a `torch.autograd.Function`.  The CUDA kernel is `tngp_torch/csrc/scatter.cu`; see
its header for the design and what bounds it.
"""

from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.register(
    "scatter_add", "scatter.cu", "tngp/kernels/scatter.py:33"
)


def scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version: `index_add_` into zeros.  Out-of-range indices are an
    error here (the kernel drops them, as JAX's scatter does)."""
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals.float())


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, num_rows: int) -> torch.Tensor:
    """idx [M] int64, vals [M, C] f32 -> [num_rows, C] f32 sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel.  The
    kernel adds atomically: exact for unique indices, f32-reordering error
    (run to run) for repeated ones."""
    if _lib.use_plain(vals):
        return scatter_add_plain(idx, vals, num_rows)
    M = idx.shape[0]
    _lib.check(idx, "idx", torch.int64, (M,))
    _lib.check(vals, "vals", torch.float32, (M, None))
    if idx.device != vals.device:
        raise ValueError("idx and vals must be on one device")
    C = vals.shape[1]
    out = torch.zeros((num_rows, C), dtype=torch.float32, device=vals.device)
    _lib.launch(
        KERNEL, "tngp_scatter_add_f32", vals.device,
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), M, C, num_rows,
    )
    return out
