"""Scatters in f32 — the port of `tngp/kernels/scatter.py`.

`scatter_add`: `out[idx[j], :] += vals[j, :]`.  Its callers: the payload
sort around the window encoder and, in training, the cotangent sort of its
backward (unique indices, `kernels/window_encoder.py`), the per-ray
reduction of the stream compositor (nondecreasing indices,
`ops/composite.py`) and the eval render's per-round state update.  It is not
differentiable by itself: callers that need a gradient wrap it in a
`torch.autograd.Function`.

`scatter_set_flat`: `out[idx[j]] = vals[j]` over an `init`-filled flat
target, `idx == -1` skipped, the last write winning a cell.  Its one caller
is the grid-update stage bench (`diagnostics/bench_grid_update.py`); the
occupancy update keeps `index_put_`, as the JAX package keeps XLA's set.
The JAX package's `scatter_set_flat_auto` (Pallas on the TPU, XLA's set
elsewhere) has no counterpart here: the dispatch rule below already sends a
CPU tensor to the plain version.

Both CUDA kernels are in `tngp_torch/csrc/scatter.cu`; see its comments for
the designs and what bounds them.
"""

from __future__ import annotations

import torch

from . import _lib

KERNEL = _lib.register(
    "scatter_add", "scatter.cu", "tngp/kernels/scatter.py:33"
)
KERNEL_SET = _lib.register(
    "scatter_set", "scatter.cu", "tngp/kernels/scatter.py:181"
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


def _check_set_call(idx: torch.Tensor, num_cells: int) -> None:
    """The contract both paths of `scatter_set_flat` hold: int64 indices, and
    num_cells % 128 == 0 (the JAX kernel's lane packing needs it; kept so
    both packages accept the same calls)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"idx: expected torch.int64, got {idx.dtype}")
    if num_cells % 128 != 0:
        raise ValueError(f"num_cells must be a multiple of 128, got {num_cells}")


def scatter_set_flat_plain(idx: torch.Tensor, vals: torch.Tensor, num_cells: int,
                           init: float = -1.0) -> torch.Tensor:
    """Plain version, deterministic: the winner of a cell is the largest j
    that names it (`scatter_reduce_` "amax" of the positions), which is the
    result of the TPU kernel's sequential loop.  Skips go to an overflow
    slot.  Like the kernel it takes int64 indices only; indices outside
    [-1, num_cells) are an error here (the kernel drops them)."""
    _check_set_call(idx, num_cells)
    if bool(((idx < -1) | (idx >= num_cells)).any()):
        raise ValueError(f"scatter_set_flat: an index lies outside [-1, {num_cells})")
    M = idx.shape[0]
    out = torch.full((num_cells,), float(init), dtype=torch.float32, device=vals.device)
    if M == 0:
        return out
    slot = torch.where(idx < 0, num_cells, idx)
    winner = torch.full((num_cells + 1,), -1, dtype=torch.int64, device=vals.device)
    winner.scatter_reduce_(0, slot, torch.arange(M, device=vals.device), "amax")
    winner = winner[:num_cells]
    return torch.where(winner >= 0, vals.float()[winner.clamp(min=0)], out)


def scatter_set_flat(idx: torch.Tensor, vals: torch.Tensor, num_cells: int,
                     init: float = -1.0) -> torch.Tensor:
    """idx [M] int64 flat cell indices in [0, num_cells) or -1 (skip), vals
    [M] f32 -> [num_cells] f32 filled with `init`, then out[idx[j]] = vals[j];
    on a repeated index the last write (largest j) wins.  num_cells % 128 == 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    is exact and deterministic."""
    _check_set_call(idx, num_cells)
    if _lib.use_plain(vals):
        return scatter_set_flat_plain(idx, vals, num_cells, init)
    M = idx.shape[0]
    _lib.check(idx, "idx", torch.int64, (M,))
    _lib.check(vals, "vals", torch.float32, (M,))
    if idx.device != vals.device:
        raise ValueError("idx and vals must be on one device")
    if M >= 2**31:
        raise ValueError(f"scatter_set_flat: M = {M} needs positions beyond int32")
    winner = torch.empty((num_cells,), dtype=torch.int32, device=vals.device)
    out = torch.empty((num_cells,), dtype=torch.float32, device=vals.device)
    _lib.launch(
        KERNEL_SET, "tngp_scatter_set_f32", vals.device,
        idx.data_ptr(), vals.data_ptr(), winner.data_ptr(), out.data_ptr(), M, num_cells,
        float(init),
    )
    return out
