"""Windowed hash-table parameterization of the multiresolution grid encoder
— the port of `tngp/ops/window_table.py`.

Semantics, as in the JAX package: space [0, 1]^3 is cut into 4^3 = 64 tiles;
each level owns `n_win` windows of 8192 rows (row = hi * 128 + lo); a tile
maps to window `tile * n_win // 64` and every corner of a sample uses the
window of the sample's own tile.  Levels with side^3 <= 8192 index densely;
larger levels hash with the XOR-prime `fast_hash` masked to the window.

The parameter lives in the transposed window layout `[n_windows, C, 128, 64]`
(`window_view` of the canonical `[total_rows, C]`).  `window_encode_ref` is the
plain version of the encoder over the canonical layout, and
`window_table_grad_ref` the plain table gradient over the same layout (the
oracle of the backward kernel and its sorted plain version).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

WIN_ROWS = 8192
WIN_HI = WIN_ROWS // 128  # 64
WIN_LANES = 128
TILES_SIDE = 4
N_TILES = TILES_SIDE**3  # 64

# fast_hash primes for dims 1 and 2 (dim 0's prime is 1)
P1 = 2654435761
P2 = 805459861


@dataclass(frozen=True)
class WindowSpec:
    """Static geometry of the windowed grid encoder (hashable)."""

    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    per_level_scale: float = 2.0
    log2_hashmap_size: int = 19
    align_corners: bool = False
    interpolation: str = "linear"  # 'linear' | 'smoothstep'

    @staticmethod
    def create(
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        log2_hashmap_size: int = 19,
        desired_resolution: int | None = None,
        align_corners: bool = False,
        interpolation: str = "linear",
    ) -> "WindowSpec":
        if desired_resolution is not None:
            per_level_scale = float(
                np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
            )
        return WindowSpec(
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            per_level_scale=float(per_level_scale),
            log2_hashmap_size=log2_hashmap_size,
            align_corners=align_corners,
            interpolation=interpolation,
        )

    def level_scale(self, level: int) -> float:
        return 2.0 ** (level * math.log2(self.per_level_scale)) * self.base_resolution - 1.0

    def level_side(self, level: int) -> int:
        res = int(math.ceil(self.level_scale(level))) + 1
        return res if self.align_corners else res + 1

    def level_dense(self, level: int) -> bool:
        return self.level_side(level) ** 3 <= WIN_ROWS

    def level_n_win(self, level: int) -> int:
        cells = self.level_side(level) ** 3
        cap = 2**self.log2_hashmap_size
        return max(1, min(N_TILES, -(-min(cells, cap) // WIN_ROWS)))

    @property
    def win_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for l in range(self.num_levels):
            offs.append(offs[-1] + self.level_n_win(l))
        return tuple(offs)

    @property
    def n_windows(self) -> int:
        return self.win_offsets[-1]

    @property
    def total_rows(self) -> int:
        return self.n_windows * WIN_ROWS

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def shift(self) -> float:
        return 0.0 if self.align_corners else 0.5

    def tile_window(self, level: int) -> np.ndarray:
        """[N_TILES] int32: window index (within the level) for each tile."""
        nw = self.level_n_win(level)
        return (np.arange(N_TILES, dtype=np.int32) * nw) // N_TILES

    def const_tables(self):
        """(scales f32 [L], sides i32 [L], dense i32 [L], twin i32 [L, 64],
        woff i32 [L]) as numpy."""
        L = self.num_levels
        scales = np.array([self.level_scale(l) for l in range(L)], np.float32)
        sides = np.array([self.level_side(l) for l in range(L)], np.int32)
        dense = np.array([int(self.level_dense(l)) for l in range(L)], np.int32)
        twin = np.stack([self.tile_window(l) for l in range(L)]).astype(np.int32)
        woff = np.array(self.win_offsets[:-1], np.int32)
        return scales, sides, dense, twin, woff

    def init_table_win(self, generator: torch.Generator | None = None,
                       device="cuda") -> torch.Tensor:
        """U(-1e-4, 1e-4) in the window layout [NW, C, 128, 64] (the JAX
        package's init distribution; torch draws other numbers)."""
        shape = (self.n_windows, self.level_dim, WIN_LANES, WIN_HI)
        u = torch.rand(shape, generator=generator, dtype=torch.float32, device="cpu")
        return (u * 2e-4 - 1e-4).to(device)


def window_view(table: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """[total_rows, C] canonical -> [n_windows, C, 128, 64] window layout."""
    C = spec.level_dim
    return table.reshape(spec.n_windows, WIN_HI, WIN_LANES, C).permute(0, 3, 2, 1)


def window_unview(win: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """Inverse of window_view: [NW, C, 128, 64] -> [total_rows, C]."""
    C = spec.level_dim
    return win.permute(0, 3, 2, 1).reshape(spec.total_rows, C)


def sample_tiles(x01_cf: torch.Tensor) -> torch.Tensor:
    """[3, B] in [0,1] -> [B] int64 tile id (x-major, z-fastest); a NaN
    coordinate maps to tile row 0 so that the id stays in range."""
    ti = torch.floor(torch.nan_to_num(x01_cf, nan=0.0) * TILES_SIDE)
    ti = torch.clamp(ti, 0, TILES_SIDE - 1).long()
    return (ti[0] * TILES_SIDE + ti[1]) * TILES_SIDE + ti[2]


def _corner_rows(spec: WindowSpec, level: int, x01: torch.Tensor):
    """Per-corner window rows + interpolation weights at `level`.

    x01: [3, B] in [0,1].  Returns (rows [8, B] int64 in [0, WIN_ROWS) for
    inputs in [0, 1], weights [8, B] f32).  The hash is uint32 arithmetic;
    only its low 13 bits survive the mask, so int64 products give the same
    rows."""
    scale = spec.level_scale(level)
    side = spec.level_side(level)
    pos = x01.float() * scale + spec.shift
    pg = torch.floor(pos)
    frac = pos - pg
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    pgi = pg.long()
    rows, ws = [], []
    for k in range(8):
        cc = [pgi[d] + ((k >> d) & 1) for d in range(3)]
        if spec.level_dense(level):
            row = cc[0] + cc[1] * side + cc[2] * (side * side)
        else:
            row = (cc[0] ^ (cc[1] * P1) ^ (cc[2] * P2)) & (WIN_ROWS - 1)
        rows.append(row)
        w = torch.ones_like(frac[0])
        for d in range(3):
            w = w * (frac[d] if (k >> d) & 1 else 1.0 - frac[d])
        ws.append(w)
    return torch.stack(rows), torch.stack(ws)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def window_encode_ref(
    x01_cf: torch.Tensor,
    table: torch.Tensor,
    spec: WindowSpec,
    emulate_bf16: bool = False,
) -> torch.Tensor:
    """Plain version of the windowed encoding.

    x01_cf: [3, B] in [0,1]; table: [total_rows, C] canonical layout.
    Returns [L*C, B] (level-major).  emulate_bf16=True rounds each corner's
    table value and weight to bf16 and accumulates the products in f32 — the
    numerics of the encoder kernels (the JAX package's default MXU pass)."""
    L, C = spec.num_levels, spec.level_dim
    B = x01_cf.shape[1]
    tile = sample_tiles(x01_cf)
    table_t = table.float().T  # [C, total_rows]
    outs = []
    for level in range(L):
        rows, ws = _corner_rows(spec, level, x01_cf)  # [8, B]
        twin = torch.as_tensor(spec.tile_window(level), device=x01_cf.device).long()
        w_id = spec.win_offsets[level] + twin[tile]  # [B]
        grow = w_id[None, :] * WIN_ROWS + rows  # [8, B]
        vals = table_t[:, grow.reshape(-1)].reshape(C, 8, B)
        if emulate_bf16:
            vals = _bf16_round(vals)
            ws = _bf16_round(ws)
        outs.append(torch.sum(ws[None] * vals, dim=1))  # [C, B]
    return torch.cat(outs, dim=0).to(table.dtype)


def window_table_grad_ref(
    x01_cf: torch.Tensor,
    g: torch.Tensor,
    spec: WindowSpec,
    emulate_bf16: bool = False,
) -> torch.Tensor:
    """Plain table gradient of the windowed encoding.

    x01_cf: [3, B] in [0,1]; g: [L*C, B] cotangents of the features.
    Returns [total_rows, C] f32 (canonical layout): every corner's
    `w * g` added into its row; rows no sample touches are zero.
    emulate_bf16=True rounds each PRODUCT `w * g` to bf16 once and sums in
    f32 — the numerics of the backward kernel (the JAX package's default
    MXU pass rounds the product, unlike the forward, which rounds the weight
    and the table value separately)."""
    L, C = spec.num_levels, spec.level_dim
    B = x01_cf.shape[1]
    tile = sample_tiles(x01_cf)
    g = g.float().reshape(L, C, 1, B)
    out = torch.zeros((spec.total_rows * C,), dtype=torch.float32, device=x01_cf.device)
    chan = torch.arange(C, device=x01_cf.device)[:, None, None]
    for level in range(L):
        rows, ws = _corner_rows(spec, level, x01_cf)  # [8, B]
        twin = torch.as_tensor(spec.tile_window(level), device=x01_cf.device).long()
        w_id = spec.win_offsets[level] + twin[tile]  # [B]
        grow = w_id[None, :] * WIN_ROWS + rows  # [8, B]
        contrib = ws[None] * g[level]  # [C, 8, B]
        if emulate_bf16:
            contrib = _bf16_round(contrib)
        out.index_add_(0, (grow[None] * C + chan).reshape(-1), contrib.reshape(-1))
    return out.reshape(spec.total_rows, C)
