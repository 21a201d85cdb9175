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
  call per level, `ops/hashgrid.py`; TensoRF's and CCNeRF's factor
  gradients, `ops/grid_sample.py`).  One of four designs, picked by
  `any_form(n, C, num_rows)` from the shapes alone: "owner" and "shared"
  keep the whole output in a block's shared memory, as the TPU kernel
  keeps it in VMEM ("owner" deterministic, bitwise the same on every call
  on one card; "shared" with shared-memory atomics); "warp" sums a run of
  lanes that name one row before one global atomic; "rows" is one global
  vector atomic a 16-byte chunk.  All but "owner": f32 reordering error,
  not bitwise reproducible.  Zeros in vals are skipped, which is exact.
  One launch is counted under `scatter_add_any` however many device
  kernels it enqueues, and once under its design in that kernel's
  `forms`.

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

import functools
from dataclasses import dataclass

import torch

from ..utils.profiling import span
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
    form's kernel ("any": the design `any_form` picks)."""
    if indices not in INDICES:
        raise ValueError(f"indices must be one of {INDICES}, got {indices!r}")
    if _lib.use_plain(vals):
        return scatter_add_plain(idx, vals, num_rows, indices)
    _check_add_call(idx, vals)
    if indices == "any":
        with span("tngp.kernel.scatter_add_any"):
            return _launch_any(idx, vals, num_rows, None)
    M, C = vals.shape
    out = torch.empty((num_rows, C), dtype=torch.float32, device=vals.device)
    _lib.launch(KERNELS_ADD[indices], vals.device, idx.data_ptr(), vals.data_ptr(), out.data_ptr(), M, C,
                num_rows)
    return out


# The general form's designs, numbered as `tngp_scatter_add_any_f32` takes them.
ANY_FORMS = ("rows", "warp", "shared", "owner")
SMEM_BUDGET = 232_448  # dynamic shared memory a block may opt in to on sm_90
S_MIN_ADDS = 200  # adds a row from which a shared-memory accumulator pays
OWNER_MIN_COLUMNS = 384  # owned columns a block (copies x C) for the owner design
OWNER_MAX_THREADS = 512
SHARED_MAX_C = 16  # wider rows: the shared atomics cost more than global ones
WARP_MAX_C = 8  # narrow rows: the warp design's lane-a-row loads stay cheap
SHARED_THREADS = 1024
WARP_THREADS = 256
H100_SMS = 132


@dataclass(frozen=True)
class AnyPlan:
    """One launch of the general form: its design, threads a block, blocks
    (0: the launcher's own grid), dynamic shared memory in bytes and the
    scratch floats for the blocks' partials (0: none)."""

    form: str
    threads: int
    blocks: int
    smem: int
    scratch: int


def any_form(n: int, C: int, num_rows: int, sms: int = H100_SMS,
             form: str | None = None) -> AnyPlan:
    """The general form's launch for `n` rows of `C` floats into `num_rows`
    rows on a card of `sms` multiprocessors, from these shapes alone (so
    the choice makes no host sync).  `form` forces a design (the checks
    hold each against the plain version); a shared-memory design the
    output does not fit raises `ValueError`.

    - "owner": the output (num_rows * C * 4 bytes) fits one block's
      SMEM_BUDGET, there are S_MIN_ADDS adds a row or more, and its private
      copies give OWNER_MIN_COLUMNS owned columns (the wide lines);
    - "shared": the output fits, C <= SHARED_MAX_C and there are
      S_MIN_ADDS * max(1, C / 2) adds a row or more (a shared add is a
      compare-and-swap a float, so wider rows need more crowding to pay:
      level 0 of the grids, TensoRF's rank-16 lines at 128);
    - "warp": C <= WARP_MAX_C (the grids' other levels, CCNeRF's rank-4
      planes, the per-ray rows);
    - "rows": everything else (wide rows with few adds a row), and n = 0.
    The thresholds come from the paths' own inputs on an H100 (PERF.md,
    section 6: `diagnostics/any_calls.py`)."""
    acc = num_rows * C * 4
    fits = 0 < acc <= SMEM_BUDGET
    width = -(-C // 32) * 32  # an owner group's threads: C in whole warps
    groups = min(SMEM_BUDGET // acc, OWNER_MAX_THREADS // width) if fits else 0
    if form is None:
        if n <= 0 or acc <= 0:
            form = "rows"
        elif fits and n >= S_MIN_ADDS * num_rows and groups * C >= OWNER_MIN_COLUMNS:
            form = "owner"
        elif fits and C <= SHARED_MAX_C and n >= S_MIN_ADDS * max(1, C // 2) * num_rows:
            form = "shared"
        elif C <= WARP_MAX_C:
            form = "warp"
        else:
            form = "rows"
    if form not in ANY_FORMS:
        raise ValueError(f"form must be one of {ANY_FORMS}, got {form!r}")
    if form == "rows":
        return AnyPlan(form, 256, 0, 0, 0)
    if form == "warp":
        return AnyPlan(form, WARP_THREADS, max(1, -(-n // WARP_THREADS)), 0, 0)
    if not fits or (form == "owner" and groups < 1):
        raise ValueError(f"scatter_add any: [{num_rows}, {C}] ({acc:,} bytes) does not fit the "
                         f"{form} design's shared memory ({SMEM_BUDGET:,} bytes a block)")
    blocks = max(1, min(sms, n // max(1024, 2 * num_rows)))
    scratch = blocks * num_rows * C if blocks > 1 else 0
    if form == "owner":
        return AnyPlan(form, groups * width, blocks, groups * acc, scratch)
    return AnyPlan(form, SHARED_THREADS, blocks, acc, scratch)


def any_designs(n: int, C: int, num_rows: int) -> list:
    """The designs of the general form that can take [n, C] -> [num_rows, C]
    (every one for `scatter_add_any_as` to hold or time)."""
    out = []
    for form in ANY_FORMS:
        try:
            any_form(n, C, num_rows, form=form)
        except ValueError:
            continue
        out.append(form)
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_any(idx: torch.Tensor, vals: torch.Tensor, num_rows: int,
                form: str | None) -> torch.Tensor:
    """The general form's launch on the card, `form` forced or chosen by
    `any_form`; counted once under `scatter_add_any` and once under its
    design in that kernel's `forms`."""
    M, C = vals.shape
    plan = any_form(M, C, num_rows, _sms(vals.get_device()), form)
    out = torch.empty((num_rows, C), dtype=torch.float32, device=vals.device)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=vals.device)
               if plan.scratch else None)
    info = KERNELS_ADD["any"]
    _lib.launch(info, vals.device, idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), M, C, num_rows,
                ANY_FORMS.index(plan.form), plan.threads, plan.blocks, plan.smem)
    info.forms[plan.form] = info.forms.get(plan.form, 0) + 1
    return out


def scatter_add_any_as(idx: torch.Tensor, vals: torch.Tensor, num_rows: int,
                       form: str) -> torch.Tensor:
    """`scatter_add(..., indices="any")` through the design `form` (one of
    ANY_FORMS) whatever `any_form` would pick: for holding each design
    against the plain version and timing it.  CPU tensors take the plain
    version."""
    if _lib.use_plain(vals):
        return scatter_add_plain(idx, vals, num_rows)
    _check_add_call(idx, vals)
    return _launch_any(idx, vals, num_rows, form)


def _check_add_call(idx: torch.Tensor, vals: torch.Tensor) -> None:
    M = idx.shape[0]
    _lib.check(idx, "idx", torch.int64, (M,))
    _lib.check(vals, "vals", torch.float32, (M, None))
    if idx.get_device() != vals.get_device():
        raise ValueError("idx and vals must be on one device")


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
