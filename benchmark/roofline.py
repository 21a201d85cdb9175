"""The yardstick's arithmetic: the chip's published peaks and the bytes a
kernel call must move, computed from its inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.  A share of a peak
is stated with the card's power limit beside it.

`encoder_bytes` and `encoder_bwd_bytes` are frozen copies of
`tngp_torch/diagnostics/kernel_times.py` `encoder_bytes` ("fwd", "bwd"),
with the corner addressing of the window layout written out here
(`reference.ngp.levels` gives the geometry)."""

from __future__ import annotations

import torch

from .reference.ngp import P1, P2, WIN_LANES, WIN_ROWS, levels, n_windows

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def corner_addresses(xyz4: torch.Tensor, wob: torch.Tensor, cfg: dict, block: int,
                     level: int):
    """(addr [8, M_pad] flat index of channel 0 into the window-layout
    table, weight [8, M_pad] with the sample's validity folded in) of every
    tile-sorted sample's 8 corners at `level`; `wob` [L, NB] is each block's
    window within the level."""
    scale, side, dense, _, first = levels(cfg)[level]
    C = cfg["level_dim"]
    x01, valid = xyz4[:, :3].T.float(), xyz4[:, 3]
    pos = x01 * scale + 0.5
    pg = torch.floor(pos)
    fr = pos - pg
    pgi = pg.long()
    win = first + wob[level].long()[torch.arange(xyz4.shape[0], device=xyz4.device) // block]
    addrs, ws = [], []
    for k in range(8):
        bits = [(k >> a) & 1 for a in range(3)]
        cx, cy, cz = (pgi[a] + bits[a] for a in range(3))
        w = torch.ones_like(fr[0])
        for a in range(3):
            w = w * (fr[a] if bits[a] else 1.0 - fr[a])
        if dense:
            row = cx + cy * side + cz * side * side
            w = torch.where((row >= 0) & (row < WIN_ROWS), w, torch.zeros_like(w))
        else:
            row = cx ^ (cy * P1) ^ (cz * P2)
        row = row & (WIN_ROWS - 1)
        addrs.append(win * (C * WIN_ROWS) + (row & (WIN_LANES - 1)) * (WIN_ROWS // WIN_LANES)
                     + (row >> 7))
        ws.append(w * valid)
    return torch.stack(addrs), torch.stack(ws)


def encoder_bytes(xyz4: torch.Tensor, wob: torch.Tensor, cfg: dict, block: int) -> int:
    """Bytes an encoder forward call must move.  Per sample: its xyz4 row
    (16 B) and its L * C features written; `wob` once; each table entry
    (window, channel, row) that a live sample's corner weighs with a
    nonzero weight, read once."""
    L, C = cfg["num_levels"], cfg["level_dim"]
    entries = 0
    for lv in range(L):
        addr, w = corner_addresses(xyz4, wob, cfg, block, lv)
        entries += int(torch.unique(addr[w.ne(0)]).numel()) * C
    return xyz4.shape[0] * (16 + 4 * L * C) + wob.numel() * 4 + entries * 4


def encoder_bwd_bytes(m_pad: int, wob_entries: int, cfg: dict) -> int:
    """Bytes an encoder table-gradient call must move, from its input sizes
    (`util.encoder_bwd_calls`).  Per sample: its xyz4 row (16 B) and its
    L * C cotangents read; `wob` once; the whole window-layout table
    gradient written once."""
    L, C = cfg["num_levels"], cfg["level_dim"]
    return m_pad * (16 + 4 * L * C) + wob_entries * 4 + n_windows(cfg) * C * WIN_ROWS * 4


def add_bytes(m: int, c: int, rows_out: int) -> int:
    """A scatter-add's bytes (a frozen copy of `chip_smoke.py`'s
    `add_bytes`): m int64 indices and [m, c] f32 values read once, the [rows_out,
    c] output written once."""
    return m * 8 + m * c * 4 + rows_out * c * 4


def bound_share(total_bytes: float, device_s: float) -> float | None:
    """Percent of the HBM roofline: (bytes / peak bandwidth) / device time;
    None where no device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * total_bytes / PEAK_HBM_BYTES / device_s

