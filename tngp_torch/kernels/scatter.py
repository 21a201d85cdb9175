"""Scatters in f32 — the port of `tngp/kernels/scatter.py`.

`scatter_add(idx, vals, num_rows, *, indices="any")`:
`out[idx[j], :] += vals[j, :]` into zeros, rows outside [0, num_rows)
dropped, as the JAX function computes it.  `indices` is the caller's
statement of what it knows about `idx`; it changes nothing in the result,
only which CUDA form computes it:

- `"unique"`: no index repeats (the payload sort around the window encoder
  and, in training, the cotangent sort of its backward: `bin_dest`'s
  destinations; the frame renderer's per-round state update,
  `render/frame_eval.py`).  A store per row, no atomics; exact.
- `"sorted"`: the indices are nondecreasing (the stream compositor's
  per-ray reduction, `ops/composite.py`, and the eval render's per-round
  state update, `render/renderer.py`).  A deterministic segmented reduce,
  bitwise the same on every run.
- `"any"`: general indices (the golden hash grid's table gradient, one
  call per level, `ops/hashgrid.py`).  Vector atomics: f32 reordering
  error, not bitwise reproducible.

The plain version computes the same `index_add_` for every statement and,
for a CPU tensor, checks the statement: a repeated index under "unique" or
a decrease under "sorted" raises `ValueError`, so the CPU tests catch a
caller that states what its indices do not hold.  Each form is a kernel of
its own (`scatter_add_unique`, `scatter_add_sorted`, `scatter_add_any`),
so the launch counts show which path went through which.  None is
differentiable by itself: callers that need a gradient wrap it in a
`torch.autograd.Function`.

`scatter_set_flat`: `out[idx[j]] = vals[j]` over an `init`-filled flat
target, `idx == -1` skipped, the last write winning a cell.  Its one caller
is the grid-update stage bench (`diagnostics/bench_grid_update.py`); the
occupancy update keeps `index_put_`, as the JAX package keeps XLA's set.
The JAX package's `scatter_set_flat_auto` (Pallas on the TPU, XLA's set
elsewhere) has no counterpart here: the dispatch rule below already sends a
CPU tensor to the plain version.

The CUDA kernels are in `tngp_torch/csrc/scatter.cu`; see its comments for
the designs, what bounds them and why each is deterministic or not.
"""

from __future__ import annotations

import torch

from . import _lib

INDICES = ("unique", "sorted", "any")
KERNELS_ADD = {
    form: _lib.register(f"scatter_add_{form}", "scatter.cu", "tngp/kernels/scatter.py:33",
                        f"tngp_scatter_add_{form}_f32")
    for form in INDICES
}
KERNEL_SET = _lib.register(
    "scatter_set", "scatter.cu", "tngp/kernels/scatter.py:181", "tngp_scatter_set_f32"
)


def _check_indices(idx: torch.Tensor, indices: str) -> None:
    """Raise `ValueError` unless `idx` holds what `indices` states."""
    if indices not in INDICES:
        raise ValueError(f"indices must be one of {INDICES}, got {indices!r}")
    if indices == "unique" and torch.unique(idx).numel() != idx.numel():
        raise ValueError('scatter_add: indices="unique", but an index repeats')
    if indices == "sorted" and bool((idx[1:] < idx[:-1]).any()):
        raise ValueError('scatter_add: indices="sorted", but the indices decrease')


def scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor, num_rows: int,
                      indices: str = "any") -> torch.Tensor:
    """Plain version: `index_add_` into zeros, whatever `indices` says; an
    out-of-range index goes to an overflow row that is cut off.  For a CPU
    tensor the statement is checked (`_check_indices`); on the card it is
    not, so that this path makes no host sync."""
    if idx.device.type == "cpu":
        _check_indices(idx, indices)
    idx = idx.long()
    slot = torch.where((idx >= 0) & (idx < num_rows), idx, num_rows)
    out = torch.zeros((num_rows + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, slot, vals.float())[:num_rows]


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, num_rows: int, *,
                indices: str = "any") -> torch.Tensor:
    """idx [M] int64, vals [M, C] f32 -> [num_rows, C] f32 sums; rows
    outside [0, num_rows) dropped.  `indices` ("unique", "sorted" or "any")
    states what the caller knows about idx (module docstring).

    CPU tensors take the plain version; CUDA tensors launch the stated
    form's kernel."""
    if indices not in INDICES:
        raise ValueError(f"indices must be one of {INDICES}, got {indices!r}")
    if _lib.use_plain(vals):
        return scatter_add_plain(idx, vals, num_rows, indices)
    M = idx.shape[0]
    _lib.check(idx, "idx", torch.int64, (M,))
    _lib.check(vals, "vals", torch.float32, (M, None))
    if idx.get_device() != vals.get_device():
        raise ValueError("idx and vals must be on one device")
    C = vals.shape[1]
    out = torch.empty((num_rows, C), dtype=torch.float32, device=vals.device)
    _lib.launch(KERNELS_ADD[indices], vals.device, idx.data_ptr(), vals.data_ptr(), out.data_ptr(), M, C,
                num_rows)
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
    if idx.get_device() != vals.get_device():
        raise ValueError("idx and vals must be on one device")
    if M >= 2**31:
        raise ValueError(f"scatter_set_flat: M = {M} needs positions beyond int32")
    winner = torch.empty((num_cells,), dtype=torch.int32, device=vals.device)
    out = torch.empty((num_cells,), dtype=torch.float32, device=vals.device)
    _lib.launch(
        KERNEL_SET, vals.device,
        idx.data_ptr(), vals.data_ptr(), winner.data_ptr(), out.data_ptr(), M, num_cells,
        float(init),
    )
    return out
