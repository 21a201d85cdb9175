"""Occupancy bitfield packing and probing — the port of
`tngp/ops/grid_utils.py` `packbits` and `bitfield_probe`.  Cells are in
linear order (cell = (ix*H + iy)*H + iz); cell i is bit (1 << (i & 7)) of
byte i >> 3, the CUDA reference's convention."""

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
