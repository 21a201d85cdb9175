"""Multiresolution hash/tiled grid encoding — the port of
`tngp/ops/hashgrid.py` (the golden hash grid: `HashGridSpec`,
`hash_encode_cf`, `hash_encode`, `hash_encode_cf_vjp`,
`hash_encode_tv_grad`).

Semantics, as in the JAX package (torch-ngp's `gridencoder.cu`): level `l`
has scale `2^(l * log2(per_level_scale)) * base_resolution - 1`; a sample's
position on it is `x * scale + (0 if align_corners else 0.5)` in f32 (the
scale rounded to f32 first); its 2^D corners are interpolated linearly or
with smoothstep weights; a corner's row is the dense strided index while the
running stride fits in the level's table, else the XOR-prime hash
(`gridtype="hash"`) or the strided index wrapped (`"tiled"`), modulo the
level's size, plus the level's offset into the flat `[total_params, C]`
table.  Samples with a coordinate outside [0, 1] encode to 0 and get no
gradient.

The JAX package's index arithmetic is uint32 with wraparound; here it is
int64 masked to 32 bits after every multiply and add, so a negative corner
coordinate (x01 < 0, which D-NeRF's x + dx gives) takes the same two's
complement value as JAX's int32 -> uint32 cast.

The forward is torch ops (gathers), as the JAX forward is XLA outside
Pallas, accumulated level by level: all L * 2^D index rows at once would
take 134 MB of int64 at a 2^17-sample chunk in 3-D and 537 MB in the 5-D
hyper grid.  Within a level the 2^D corners are built by expanding one
dimension at a time, so a level costs a few dozen tensor operations, not a
few per corner.

`hash_encode_cf_vjp` is a `torch.autograd.Function` whose backward adds the
table gradient level by level through `tngp_torch.kernels.scatter.
scatter_add(..., indices="any")` — the general-index form of the port of the
TPU scatter kernel (`tngp/kernels/scatter.py` `_scatter_kernel`), which the
JAX backward reaches through `scatter_add_auto` — into each level's rows and
concatenates the levels, as the JAX backward does.  On the card that is the
`scatter_add_any` kernel (vector atomics: f32 reordering error, not bitwise
reproducible); on the CPU its plain version.  The input gradient (the CUDA
reference's dy_dx path) is computed only when `spec.input_grad` and the
caller's x needs one.

The forward and the backward run inside the program's spans
`tngp.encoder.hash_grid` and `tngp.encoder.hash_grid.backward`
(`utils/profiling.py`), so that a `torch.profiler` trace gives the grid's
share of device time; with no profiler running they cost nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..kernels.scatter import scatter_add
from ..utils.profiling import span

# Spatial hash primes, gridencoder.cu:54 (standard instant-ngp constants).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_M32 = 0xFFFFFFFF

GRIDTYPE_HASH = "hash"
GRIDTYPE_TILED = "tiled"


@dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multiresolution grid encoder (hashable); the
    fields and derived geometry of the JAX package's `HashGridSpec`."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    per_level_scale: float = 2.0
    log2_hashmap_size: int = 19
    gridtype: str = GRIDTYPE_HASH
    align_corners: bool = False
    interpolation: str = "linear"  # 'linear' | 'smoothstep'
    # whether the backward computes dL/dx (D-NeRF's deform and the hyper
    # variant's ambient coordinates need it; NGP's march positions do not)
    input_grad: bool = True

    @staticmethod
    def create(
        input_dim: int = 3,
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        log2_hashmap_size: int = 19,
        desired_resolution: int | None = None,
        gridtype: str = GRIDTYPE_HASH,
        align_corners: bool = False,
        interpolation: str = "linear",
        input_grad: bool = True,
    ) -> "HashGridSpec":
        # desired_resolution overrides per_level_scale (grid.py:758-760)
        if desired_resolution is not None:
            per_level_scale = float(
                np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
            )
        return HashGridSpec(
            input_dim=input_dim,
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            per_level_scale=float(per_level_scale),
            log2_hashmap_size=log2_hashmap_size,
            gridtype=gridtype,
            align_corners=align_corners,
            interpolation=interpolation,
            input_grad=input_grad,
        )

    @property
    def s_log2(self) -> float:
        return math.log2(self.per_level_scale)

    def level_scale(self, level: int) -> float:
        return 2.0 ** (level * self.s_log2) * self.base_resolution - 1.0

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    @property
    def max_params(self) -> int:
        return 2**self.log2_hashmap_size

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Level offsets into the flat table.  A level's size is sized from
        ceil(base * scale**l), which can differ from `level_resolution`:
        it is the JAX package's layout (grid.py:776-789), kept as it is."""
        offs = [0]
        for lv in range(self.num_levels):
            res = int(np.ceil(self.base_resolution * self.per_level_scale**lv))
            side = res if self.align_corners else res + 1
            params = min(self.max_params, side**self.input_dim)
            params = int(math.ceil(params / 8) * 8)
            offs.append(offs[-1] + params)
        return tuple(offs)

    @property
    def total_params(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def init_table(self, generator: torch.Generator | None = None, device="cuda",
                   dtype=torch.float32) -> torch.Tensor:
        """U(-1e-4, 1e-4) `[total_params, C]` (grid.py:796-798), drawn on the
        CPU from `generator` (torch draws other numbers than jax.random)."""
        u = torch.rand((self.total_params, self.level_dim), generator=generator,
                       dtype=torch.float32, device="cpu")
        return (u * 2e-4 - 1e-4).to(device=device, dtype=dtype)


def _level_plan(spec: HashGridSpec, level: int):
    """(hashmap_size, dense strides, use_hash) of a level: the strides of the
    dimensions the dense index covers (the running stride still fits in the
    level's table), and whether the XOR-prime hash replaces it
    (gridencoder.cu:67-84)."""
    offsets = spec.offsets
    hashmap_size = offsets[level + 1] - offsets[level]
    res = spec.level_resolution(level)
    side = res if spec.align_corners else res + 1
    strides = []
    stride = 1
    for _ in range(spec.input_dim):
        if stride > hashmap_size:
            break
        strides.append(stride)
        stride *= side
    use_hash = spec.gridtype == GRIDTYPE_HASH and stride > hashmap_size
    return hashmap_size, strides, use_hash


def _expand(per_dim, combine):
    """Corner tensor [2^D, B] from per-dimension [2, B] terms: corner k takes
    term b = (k >> d) & 1 of dimension d, folded left to right with
    `combine(new, acc)`."""
    acc = per_dim[0]
    for t in per_dim[1:]:
        acc = combine(t[:, None], acc[None]).reshape(-1, acc.shape[-1])
    return acc


def _dim_term(c: torch.Tensor, d: int, strides: list, use_hash: bool) -> torch.Tensor:
    """Dimension d's uint32 share of a row for corner coordinates `c`
    (int64, any shape; negative values wrap as JAX's int32 -> uint32 cast):
    c * prime_d for the hash, c * stride_d along the dense walk, 0 for a
    dimension past the strides that fit the level's table."""
    c = c & _M32
    if use_hash:
        return (c * _PRIMES[d]) & _M32
    if d < len(strides):
        return (c * (strides[d] & _M32)) & _M32
    return torch.zeros_like(c)


def _fold(use_hash: bool):
    """How the dimensions' terms combine into a row: XOR for the hash, the
    uint32 sum for the dense walk."""
    return torch.bitwise_xor if use_hash else (lambda a, b: (a + b) & _M32)


def _level_indices_cf(spec: HashGridSpec, level: int, cc: list) -> torch.Tensor:
    """int64 table rows (level offset included) from per-dimension corner
    coordinate vectors `cc` (each [...], any integer dtype), as the JAX
    package's uint32 `_level_indices_cf`."""
    hashmap_size, strides, use_hash = _level_plan(spec, level)
    fold = _fold(use_hash)
    index = _dim_term(cc[0].long(), 0, strides, use_hash)
    for d in range(1, len(cc)):
        index = fold(_dim_term(cc[d].long(), d, strides, use_hash), index)
    return index % hashmap_size + spec.offsets[level]


def _level_rows(spec: HashGridSpec, level: int, pg: torch.Tensor) -> torch.Tensor:
    """Local rows [2^D, B] (int64, without the level offset) of the 2^D
    corners of floor cells `pg` [D, B] (int64): `_level_indices_cf`'s
    terms, taken once per dimension for its two corner coordinates and
    expanded to the corners."""
    hashmap_size, strides, use_hash = _level_plan(spec, level)
    terms = [_dim_term(torch.stack([pg[d], pg[d] + 1]), d, strides, use_hash)
             for d in range(spec.input_dim)]
    return _expand(terms, _fold(use_hash)) % hashmap_size


def _positions(x: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
    """x * scale + shift in f32 with one rounding, the scale rounded to f32
    first: XLA fuses the JAX forward's multiply and add into one f32 FMA.
    The f64 product of two f32 values is exact, and so is adding the shift
    (0.5 or 0) at these magnitudes, so rounding the f64 result to f32 gives
    the FMA's value on the CPU and on the card alike (two f32 roundings
    would move `floor` at cell edges)."""
    s32 = float(np.float32(scale))
    return (x.double() * s32 + shift).float()


def _level_geometry(spec: HashGridSpec, level: int, x: torch.Tensor):
    """Interpolation geometry of level `level` for x [D, B] f32.  Returns
    (rows [2^D, B] int64 local to the level, w [2^D, B] f32 corner weights,
    frac [D, B], raw_frac [D, B] before smoothstep)."""
    scale = spec.level_scale(level)
    shift = 0.0 if spec.align_corners else 0.5
    pos = _positions(x, scale, shift)
    pos_grid = torch.floor(pos)
    raw_frac = pos - pos_grid
    frac = raw_frac
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    pg = pos_grid.long()
    rows = _level_rows(spec, level, pg)
    w = _expand([torch.stack([1.0 - frac[d], frac[d]]) for d in range(spec.input_dim)],
                torch.mul)
    return rows, w, frac, raw_frac


def _check_input(x_cf: torch.Tensor, spec: HashGridSpec) -> None:
    if x_cf.dim() != 2 or x_cf.shape[0] != spec.input_dim:
        raise ValueError(f"expected [{spec.input_dim}, B] channels-first input, "
                         f"got {tuple(x_cf.shape)}")


def _out_of_bounds(x: torch.Tensor) -> torch.Tensor:
    return ((x < 0.0) | (x > 1.0)).any(dim=0)  # [B]


def hash_encode_cf(x_cf: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Channels-first encode: x_cf [D, B] in [0, 1] -> features [L*C, B]
    in the table's dtype, level-major (row l*C + c).  Plain torch ops: its
    gradients, where autograd takes them, are torch's own gather backward."""
    _check_input(x_cf, spec)
    with span("tngp.encoder.hash_grid"):
        B = x_cf.shape[1]
        L = spec.num_levels
        x = x_cf.float()
        table_f = table.float()
        out = []
        for level in range(L):
            rows, w, _, _ = _level_geometry(spec, level, x)
            vals = table_f[rows + spec.offsets[level]]  # [2^D, B, C]
            out.append((w[:, :, None] * vals).sum(dim=0).T)  # [C, B]
        out = torch.cat(out, dim=0) if out else x.new_zeros((0, B))
        out = torch.where(_out_of_bounds(x)[None, :], torch.zeros_like(out), out)
        return out.to(table.dtype)


def hash_encode(inputs: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Batch-first: [..., D] in [0, 1] -> [..., L*C] (see hash_encode_cf)."""
    if inputs.shape[-1] != spec.input_dim:
        raise ValueError(f"expected [..., {spec.input_dim}] inputs, got {tuple(inputs.shape)}")
    prefix = inputs.shape[:-1]
    out = hash_encode_cf(inputs.reshape(-1, spec.input_dim).T, table, spec)
    return out.T.reshape(*prefix, spec.output_dim)


class _HashEncodeVJP(torch.autograd.Function):
    """`hash_encode_cf` with the JAX package's hand-written backward."""

    @staticmethod
    def forward(ctx, x_cf, table, spec):
        ctx.spec = spec
        ctx.save_for_backward(x_cf, table)
        return hash_encode_cf(x_cf, table, spec)

    @staticmethod
    def backward(ctx, g):
        with span("tngp.encoder.hash_grid.backward"):
            return _HashEncodeVJP._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        spec = ctx.spec
        x_cf, table = ctx.saved_tensors
        D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
        B = x_cf.shape[1]
        x = x_cf.float()
        valid = (~_out_of_bounds(x)).float()
        g = g.float().reshape(L, C, B) * valid[None, None, :]
        want_dx = spec.input_grad and ctx.needs_input_grad[0]
        table_f = table.float() if want_dx else None
        grad_levels = []
        gx = torch.zeros((D, B), dtype=torch.float32, device=x.device) if want_dx else None
        for level in range(L):
            rows, w, frac, raw_frac = _level_geometry(spec, level, x)
            gl = g[level]  # [C, B]
            # table gradient: rows[k] += w[k] * gl over this level's rows
            vals = (w[:, :, None] * gl.T[None]).reshape(-1, C)  # [2^D * B, C]
            size = spec.offsets[level + 1] - spec.offsets[level]
            grad_levels.append(scatter_add(rows.reshape(-1), vals, size, indices="any"))
            if not want_dx:
                continue
            # input gradient: dL/dfrac_d = sum_k gv_k * dw_k / dfrac_d
            vals_g = table_f[rows + spec.offsets[level]]  # [2^D, B, C]
            gv = (vals_g * gl.T[None]).sum(dim=-1)  # [2^D, B]
            scale = spec.level_scale(level)
            if spec.interpolation == "smoothstep":
                dfrac = 6.0 * raw_frac * (1.0 - raw_frac)
            else:
                dfrac = torch.ones_like(frac)
            sign = torch.stack([-torch.ones_like(frac[0]), torch.ones_like(frac[0])])
            for d in range(D):
                # sign of corner bit d times the other dimensions' weights
                dw_k = _expand([sign if d2 == d else torch.stack([1.0 - frac[d2], frac[d2]])
                                for d2 in range(D)], torch.mul)
                dw = (gv * dw_k).sum(dim=0)
                gx[d] += dw * scale * dfrac[d] * valid
        grad_table = torch.cat(grad_levels, dim=0).to(table.dtype)
        return (gx.to(x_cf.dtype) if want_dx else None), grad_table, None


def hash_encode_cf_vjp(x_cf: torch.Tensor, table: torch.Tensor, spec: HashGridSpec):
    """`hash_encode_cf` whose backward gives the table gradient through the
    `scatter_add_any` kernel (on the card) and the analytic input gradient
    when `spec.input_grad` (module docstring)."""
    _check_input(x_cf, spec)
    return _HashEncodeVJP.apply(x_cf, table, spec)


def hash_encode_tv_grad(inputs: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                        weight: float = 1e-7) -> torch.Tensor:
    """Total-variation gradient for the table (gridencoder.cu:503-607): the
    gradient of 0.5 * weight * sum over samples, levels and dimensions of
    (v(floor cell) - v(floor cell + e_d))^2, neighbours past the level's
    resolution left out.  Returns `[total_params, C]` to add to the table's
    gradient.  The JAX function runs op by op (`jax.grad` of a Python
    function, not jitted), so its cells come from `x * scale + shift` with
    two f32 roundings; so do these."""
    x = inputs.reshape(-1, spec.input_dim).float()
    tbl = table.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for level in range(spec.num_levels):
            scale = spec.level_scale(level)
            shift = 0.0 if spec.align_corners else 0.5
            res = spec.level_resolution(level)
            pos_grid = torch.floor(x * scale + shift).long()  # [N, D]
            cols = [pos_grid[:, d] for d in range(spec.input_dim)]
            v0 = tbl[_level_indices_cf(spec, level, cols)]
            for d in range(spec.input_dim):
                nb = list(cols)
                nb[d] = cols[d] + 1
                ok = nb[d] < res
                vi = tbl[_level_indices_cf(spec, level, nb)]
                diff = torch.where(ok[:, None], v0 - vi, torch.zeros_like(v0))
                total = total + 0.5 * (diff.float() ** 2).sum()
        energy = weight * total
        (grad,) = torch.autograd.grad(energy, tbl)
    return grad
