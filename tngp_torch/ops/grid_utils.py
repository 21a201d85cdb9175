"""Occupancy-grid utility ops — the port of `tngp/ops/grid_utils.py`:
`packbits`, `bitfield_probe`, and the Morton codes `morton3d` /
`morton3d_invert` (kept for tooling and converting reference checkpoints;
the grid itself is linear, as in the JAX package).  Cells are in linear
order (cell = (ix*H + iy)*H + iz); cell i is bit (1 << (i & 7)) of byte
i >> 3, the CUDA reference's convention.  The Morton codes' uint32
arithmetic is int64 masked to 32 bits after every multiply."""

from __future__ import annotations

import torch


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Density grid [..., N] (N % 8 == 0) -> uint8 bitfield [..., N // 8];
    bit i of byte b is set iff grid[b*8 + i] > thresh."""
    occ = (grid > thresh).to(torch.uint8)
    occ = occ.reshape(*grid.shape[:-1], grid.shape[-1] // 8, 8)
    # built on the device: an upload would make the host wait for the stream
    weights = (2 ** torch.arange(8, device=grid.device)).to(torch.uint8)
    return (occ * weights).sum(dim=-1, dtype=torch.uint8)


def bitfield_probe(bitfield: torch.Tensor, cell_index: torch.Tensor) -> torch.Tensor:
    """uint8 bitfield, int cell indices -> bool occupancy.

    Probes through an int32-word view (little-endian: byte b is bits
    [8b, 8b+8) of its word) with an arithmetic shift, as the JAX package."""
    words = bitfield.contiguous().view(torch.int32)
    idx = cell_index.long()
    w = words[idx >> 5]
    bit = (w >> (idx & 31).to(torch.int32)) & 1
    return bit.to(torch.bool)


_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = ((v * 0x00010001) & _M32) & 0xFF0000FF
    v = ((v * 0x00000101) & _M32) & 0x0F00F00F
    v = ((v * 0x00000011) & _M32) & 0xC30C30C3
    v = ((v * 0x00000005) & _M32) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer coords (10 bits each) -> [...] Morton codes, uint32
    values in int64."""
    c = coords.long() & _M32
    return (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2)) & _M32


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """[...] Morton codes -> [..., 3] int32 coords."""
    c = codes.long() & _M32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1), _compact_bits(c >> 2)],
                       dim=-1).to(torch.int32)
