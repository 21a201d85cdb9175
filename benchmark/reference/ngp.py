"""Plain reference of the instant-NGP configuration's field: the windowed
multiresolution hash encoding, the two bias-free MLPs, spherical harmonics
of degree 4 and the activations; `volume.py` renders, trains and checks
with it.

Plain PyTorch in float32, written from the published equations and the
configuration file alone: it imports nothing of the program.

`precision="low"` is the control: the encoder's and the MLPs' operands
rounded to float8 e4m3 under a per-tensor scale (the configuration states
bfloat16 there) and the field's outputs to bfloat16 (float32 there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import volume
from .volume import TruncExp, bf16, fp8, mlp, same

WIN_ROWS = 8192  # rows of one window of the windowed table
WIN_LANES = 128  # row = hi * 128 + lo; the table is [windows, C, lo, hi]
TILES_SIDE = 4  # the unit cube is cut into 4^3 tiles, each with a window per level
P1, P2 = 2654435761, 805459861  # the spatial hash's primes for y and z (x's is 1)
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792,
        0.94617469575755997, 0.31539156525251999, 0.54627421529603959,
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)

LEAVES = ("encoder.embeddings", "sigma_net.dense_0", "sigma_net.dense_1",
          "color_net.dense_0", "color_net.dense_1", "color_net.dense_2")


# ------------------------------------------------------------------- weights
def layer_shapes(cfg: dict) -> dict:
    """Shape of each leaf: the table [windows, C, 128, 64] and each MLP
    layer [fan_in, fan_out]."""
    sh = cfg["sh_degree"] ** 2
    enc = cfg["num_levels"] * cfg["level_dim"]
    shapes = {"encoder.embeddings": (n_windows(cfg), cfg["level_dim"], WIN_LANES,
                                     WIN_ROWS // WIN_LANES)}
    dims = [enc] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) + [1 + cfg["geo_feat_dim"]]
    for i in range(cfg["num_layers"]):
        shapes[f"sigma_net.dense_{i}"] = (dims[i], dims[i + 1])
    c_in = sh + cfg["geo_feat_dim"] + 1  # one zero pad
    dims = [c_in] + [cfg["hidden_dim_color"]] * (cfg["num_layers_color"] - 1) + [3]
    for i in range(cfg["num_layers_color"]):
        shapes[f"color_net.dense_{i}"] = (dims[i], dims[i + 1])
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from `seed`, drawn on `device` in two
    calls: the table U(-1e-4, 1e-4) and every MLP weight U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = layer_shapes(cfg)
    tab = shapes["encoder.embeddings"]
    out = {"encoder.embeddings": torch.rand(tab, generator=gen, device=device) * 2e-4 - 1e-4}
    mlp_keys = [k for k in shapes if k != "encoder.embeddings"]
    sizes = [math.prod(shapes[k]) for k in mlp_keys]
    u = torch.rand((sum(sizes),), generator=gen, device=device) * 2.0 - 1.0
    for k, part in zip(mlp_keys, torch.split(u, sizes)):
        out[k] = (part / math.sqrt(shapes[k][0])).reshape(shapes[k])
    return out


def forward_flops(cfg: dict) -> int:
    """Floating-point operations of one sample's forward, written out: the
    MLPs' products (2 fan_in fan_out a layer), the encoding (a level: the
    position's 3 multiply-adds and floors, then a corner: its weight's 3
    factors and 2 products, and C multiply-adds), the degree-4 harmonics
    (30), the activations (4) and the sample's share of compositing (12: its
    optical depth, transmittance, weight and 3 weighted colours)."""
    mlps = sum(2 * math.prod(s) for k, s in layer_shapes(cfg).items()
               if k != "encoder.embeddings")
    enc = cfg["num_levels"] * (9 + 8 * (3 + 2 + 2 * cfg["level_dim"]))
    return mlps + enc + 30 + 4 + 12


# ------------------------------------------------------------------ encoding
def levels(cfg: dict) -> list:
    """Per level: (scale, side, dense, windows, first window)."""
    L, base = cfg["num_levels"], cfg["base_resolution"]
    pls = float(np.exp2(np.log2(cfg["desired_resolution"] / base) / (L - 1)))
    out, first = [], 0
    for lv in range(L):
        scale = 2.0 ** (lv * math.log2(pls)) * base - 1.0
        side = int(math.ceil(scale)) + 2  # corners of ceil(scale) + 1 cells, off-centre
        nw = max(1, min(TILES_SIDE ** 3, -(-min(side ** 3, 2 ** cfg["log2_hashmap_size"])
                                            // WIN_ROWS)))
        out.append((scale, side, side ** 3 <= WIN_ROWS, nw, first))
        first += nw
    return out


def n_windows(cfg: dict) -> int:
    lv = levels(cfg)[-1]
    return lv[4] + lv[3]


def encode(x01: torch.Tensor, table: torch.Tensor, cfg: dict, q=same) -> torch.Tensor:
    """x01 [M, 3] in [0, 1] -> features [M, L * C]: per level the trilinear
    blend of the 8 corners' table rows, a corner's row dense (x + y side +
    z side^2, weight 0 outside the window) or hashed (x ^ y P1 ^ z P2 in
    the window's 13 bits), in the window that the sample's tile owns."""
    C = cfg["level_dim"]
    flat = table.reshape(-1)
    ti = torch.clamp(torch.floor(x01 * TILES_SIDE), 0, TILES_SIDE - 1).long()
    tile = (ti[:, 0] * TILES_SIDE + ti[:, 1]) * TILES_SIDE + ti[:, 2]
    feats = []
    for scale, side, dense, nw, first in levels(cfg):
        pos = x01 * scale + 0.5
        pg = torch.floor(pos)
        fr = pos - pg
        pgi = pg.long()
        win = first + tile * nw // TILES_SIDE ** 3
        ws, addr = [], []
        for k in range(8):
            bits = [(k >> a) & 1 for a in range(3)]
            cx, cy, cz = (pgi[:, a] + bits[a] for a in range(3))
            w = torch.ones_like(fr[:, 0])
            for a in range(3):
                w = w * (fr[:, a] if bits[a] else 1.0 - fr[:, a])
            if dense:
                row = cx + cy * side + cz * side * side
                w = torch.where((row >= 0) & (row < WIN_ROWS), w, torch.zeros_like(w))
            else:
                row = cx ^ (cy * P1) ^ (cz * P2)
            row = row & (WIN_ROWS - 1)
            ws.append(w)
            addr.append(win * C * WIN_ROWS + (row & (WIN_LANES - 1)) * (WIN_ROWS // WIN_LANES)
                        + (row >> 7))
        w = torch.stack(ws, dim=1)  # [M, 8]
        idx = torch.stack(addr, dim=1)[:, :, None] + WIN_ROWS * torch.arange(
            C, device=x01.device)  # [M, 8, C]: channel c of the row lies c * 8192 on
        feats.append((q(w)[:, :, None] * q(flat[idx])).sum(dim=1))
    return torch.cat(feats, dim=1)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 components) of unit d [M, 3]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    x2, y2, z2 = x * x, y * y, z * z
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]),
        -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * x * y, -c[2] * y * z, c[3] * z2 - c[4], -c[2] * x * z, c[5] * (x2 - y2),
        c[6] * y * (-3.0 * x2 + y2), c[7] * x * y * z, c[8] * y * (1.0 - 5.0 * z2),
        c[9] * z * (5.0 * z2 - 3.0), c[8] * x * (1.0 - 5.0 * z2), c[10] * z * (x2 - y2),
        c[6] * x * (-x2 + 3.0 * y2),
    ], dim=1)


class Field:
    """The configuration's field over weights `w` (a dict of leaves)."""

    def __init__(self, cfg: dict, w: dict, precision: str = "f32"):
        if precision not in ("f32", "low"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.w = cfg, w
        self.q8 = fp8 if precision == "low" else same
        self.q16 = bf16 if precision == "low" else same

    def _net(self, h, net, n):
        return mlp(h, [self.w[f"{net}.dense_{i}"] for i in range(n)], self.q8)

    def __call__(self, x: torch.Tensor, d: torch.Tensor):
        """x, d [M, 3] -> sigma [M], rgb [M, 3]."""
        cfg = self.cfg
        b = cfg["bound"]
        h = encode((x + b) / (2.0 * b), self.w["encoder.embeddings"], cfg, self.q8)
        s = self._net(h, "sigma_net", cfg["num_layers"])
        sigma = TruncExp.apply(s[:, 0])
        c_in = torch.cat([sh4(d), s[:, 1:], torch.zeros_like(s[:, :1])], dim=1)
        rgb = torch.sigmoid(self._net(c_in, "color_net", cfg["num_layers_color"]))
        return self.q16(sigma), self.q16(rgb)


def budget_tiers(n_rays: int, cfg: dict) -> list:
    """The sample budgets of the adaptive budget of an instant-NGP training
    step, ascending: a quarter, a half, once and twice (at most 0.9) the
    configured compact_fraction, each `volume.train_budget`."""
    f = cfg["render"]["compact_fraction"]
    return sorted({volume.train_budget(n_rays, cfg, g)
                   for g in (f / 4.0, f / 2.0, f, min(2.0 * f, 0.9))})


def train_steps(start: dict, batches: list, bitfields: list, cfg: dict,
                precision: str = "f32") -> dict:
    """`volume.train_steps` with this configuration's field and budget
    tiers."""
    tiers = budget_tiers(batches[0]["rays_o"].shape[0], cfg)
    return volume.train_steps(lambda w: Field(cfg, w, precision), start, batches, bitfields,
                              cfg, tiers=tiers)


def render_frame(weights: dict, bitfield: torch.Tensor, cfg: dict, pose, intr, H: int, W: int,
                 precision: str = "f32"):
    """`volume.render_frame` with this configuration's field."""
    field = Field(cfg, {k: v.float() for k, v in weights.items()}, precision)
    return volume.render_frame(field, bitfield, cfg, pose, intr, H, W)
