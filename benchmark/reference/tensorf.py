"""Plain reference of the TensoRF VM configuration's field: density as the
sum over three axis pairings of plane x line factor products (bilinear and
linear samples, corners aligned, zero outside), colour as the pairings'
products through the basis matrix, frequency-encoded with the viewing
direction, into a bias-free MLP; `volume.py` renders, trains and checks
with it.  The training loss adds the L1 norm of the density factors.

Plain PyTorch in float32, from the published equations and the
configuration file alone: it imports nothing of the program.  The factors'
resolution is their shapes'; positions are normalised by a box `aabb`
(lo x, y, z, hi x, y, z), the cube [-bound, bound] where a training run
starts.  `upsample` is the shrink and upsample of the factors at a
milestone: the box of the density grid's cells above min(mean density,
density_thresh), the factors cropped to it and resized linearly (corners
aligned) to the resolution of the box's voxel size at the milestone's
resolution.

`precision="low"` is the control: the MLP's operands rounded to float8
e4m3 under a per-tensor scale (the configuration states bfloat16 there),
and the factor samples, the basis product's operands and the field's
outputs to bfloat16 (float32 there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import volume
from .volume import TruncExp, bf16, fp8, mlp, same

MAT_IDS = ((0, 1), (0, 2), (1, 2))  # the plane of pairing i spans these axes
VEC_IDS = (2, 1, 0)  # and its line the remaining one


def layer_shapes(cfg: dict) -> dict:
    """Shape of each leaf at resolution0: planes [R, res, res], lines [R,
    res], the basis [sum of colour ranks, features], MLP layers [fan_in,
    fan_out]."""
    res = cfg["resolution0"]
    shapes = {}
    for kind in ("sigma", "color"):
        for i in range(3):
            shapes[f"{kind}_mat_{i}"] = (cfg[f"{kind}_rank"][i], res, res)
    for kind in ("sigma", "color"):
        for i in range(3):
            shapes[f"{kind}_vec_{i}"] = (cfg[f"{kind}_rank"][i], res)
    shapes["basis_mat"] = (sum(cfg["color_rank"]), cfg["color_feat_dim"])
    f = cfg["freq"]
    dims = ([cfg["color_feat_dim"] * (1 + 2 * f) + 3 * (1 + 2 * f)]
            + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) + [3])
    for i in range(cfg["num_layers"]):
        shapes[f"color_net.dense_{i}"] = (dims[i], dims[i + 1])
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights from `seed`, drawn on `device` in two
    calls: every factor N(0, 0.1^2), the basis and the MLP weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = layer_shapes(cfg)
    factors = [k for k in shapes if "_mat_" in k or "_vec_" in k]
    rest = [k for k in shapes if k not in factors]
    out = {}
    for keys, draw in ((factors, lambda n: torch.randn((n,), generator=gen, device=device)
                        * 0.1),
                       (rest, lambda n: torch.rand((n,), generator=gen, device=device) * 2.0
                        - 1.0)):
        sizes = [math.prod(shapes[k]) for k in keys]
        for k, part in zip(keys, torch.split(draw(sum(sizes)), sizes)):
            out[k] = part.reshape(shapes[k])
            if k in rest:
                out[k] = out[k] / math.sqrt(shapes[k][0])
    return out


def forward_flops(cfg: dict) -> int:
    """Floating-point operations of one sample's forward, written out: per
    pairing and rank, the plane's 4 corners and the line's 2 multiply-added
    (12), the product and the sum (2), plus 12 for the corners' weights;
    the basis product (2 x 3R x F); the frequency encodings (4 a sine or
    cosine of the F features and 3 direction components, 2 each an
    octave); the MLP's products; 16 for the activations and the sample's
    share of compositing."""
    f = cfg["freq"]
    pairs = sum(14 * r + 12 for r in list(cfg["sigma_rank"]) + list(cfg["color_rank"]))
    basis = 2 * sum(cfg["color_rank"]) * cfg["color_feat_dim"]
    freq = 4 * 2 * f * (cfg["color_feat_dim"] + 3)
    mlps = sum(2 * math.prod(s) for k, s in layer_shapes(cfg).items()
               if k.startswith("color_net"))
    return pairs + basis + freq + mlps + 16


def sample2d(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """plane [R, H, W] at (u across W, v across H) in [-1, 1], corners
    aligned, zero outside -> [M, R]."""
    R, H, W = plane.shape
    fx = (u + 1.0) * 0.5 * (W - 1)
    fy = (v + 1.0) * 0.5 * (H - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0, fy - y0
    x0, y0 = x0.long(), y0.long()
    flat = plane.reshape(R, H * W)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).float()
            w = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty) * inside
            idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
            out = out + flat[:, idx].T * w[:, None]
    return out


def sample1d(line: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """line [R, D] at w in [-1, 1], ends aligned, zero outside -> [M, R]."""
    R, D = line.shape
    fx = (w + 1.0) * 0.5 * (D - 1)
    x0 = torch.floor(fx)
    tx = fx - x0
    x0 = x0.long()
    out = 0.0
    for dx in (0, 1):
        xi = x0 + dx
        inside = ((xi >= 0) & (xi < D)).float()
        out = out + line[:, torch.clamp(xi, 0, D - 1)].T * ((tx if dx else 1.0 - tx)
                                                             * inside)[:, None]
    return out


def freq(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """[M, D] -> [M, D (1 + 2 octaves)]: x, then sin and cos of 2^k x."""
    outs = [x]
    for k in range(octaves):
        outs += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(outs, dim=1)


class Field:
    """The configuration's field over weights `w` (a dict of leaves) in the
    box `aabb` (the cube [-bound, bound] where None)."""

    def __init__(self, cfg: dict, w: dict, precision: str = "f32", aabb=None):
        if precision not in ("f32", "low"):
            raise ValueError(f"precision {precision!r}")
        self.cfg, self.w = cfg, w
        b = cfg["bound"]
        box = [float(a) for a in aabb] if aabb else [-b] * 3 + [b] * 3
        self.lo, self.hi = torch.tensor(box[:3]), torch.tensor(box[3:])
        self.q8 = fp8 if precision == "low" else same
        self.q16 = bf16 if precision == "low" else same

    def _products(self, kind: str, xn: torch.Tensor) -> list:
        q = self.q16
        return [q(sample2d(self.w[f"{kind}_mat_{i}"], xn[:, m0], xn[:, m1]))
                * q(sample1d(self.w[f"{kind}_vec_{i}"], xn[:, VEC_IDS[i]]))
                for i, (m0, m1) in enumerate(MAT_IDS)]

    def __call__(self, x: torch.Tensor, d: torch.Tensor):
        """x, d [M, 3] -> sigma [M], rgb [M, 3]."""
        cfg, q = self.cfg, self.q16
        lo, hi = self.lo.to(x.device), self.hi.to(x.device)
        xn = 2.0 * (x - lo) / (hi - lo) - 1.0
        sigma = TruncExp.apply(sum(p.sum(dim=1) for p in self._products("sigma", xn)))
        feat = q(torch.cat(self._products("color", xn), dim=1)) @ q(self.w["basis_mat"])
        h = torch.cat([freq(feat, cfg["freq"]), freq(d, cfg["freq"])], dim=1)
        net = [self.w[f"color_net.dense_{i}"] for i in range(cfg["num_layers"])]
        rgb = torch.sigmoid(mlp(h, net, self.q8))
        return q(sigma), q(rgb)


def l1_density(cfg: dict):
    """The loss's L1 term: l1_reg_weight times the mean over the density
    factors of their mean absolute value."""
    def term(w: dict) -> torch.Tensor:
        sig = [v for k, v in w.items() if k.startswith("sigma_")]
        return cfg["l1_reg_weight"] * sum(v.abs().mean() for v in sig) / len(sig)
    return term


def train_steps(start: dict, batches: list, bitfields: list, cfg: dict,
                precision: str = "f32") -> dict:
    """`volume.train_steps` with this configuration's field (in the box
    `start["aabb"]`) and L1 term."""
    return volume.train_steps(lambda w: Field(cfg, w, precision, start.get("aabb")), start,
                              batches, bitfields, cfg, extra_loss=l1_density(cfg))


def resize_linear(a: torch.Tensor, n: int, dim: int, q=same) -> torch.Tensor:
    """a resized along `dim` to n entries, linearly, its ends aligned."""
    a = a.movedim(dim, -1)
    old = a.shape[-1]
    pos = torch.linspace(0.0, old - 1.0, n, dtype=torch.float64, device=a.device)
    i0 = torch.clamp(torch.floor(pos).long(), 0, old - 1)
    i1 = torch.clamp(i0 + 1, 0, old - 1)
    t = q((pos - i0.double()).float())
    return (q(a[..., i0]) * (1.0 - t) + q(a[..., i1]) * t).movedim(-1, dim)


def upsample_resolutions(cfg: dict) -> list:
    """The resolution of each upsample: log-spaced from resolution0 to
    resolution1 over the milestones, rounded."""
    n = len(cfg["upsample_model_steps"])
    r = np.round(np.exp(np.linspace(np.log(cfg["resolution0"]), np.log(cfg["resolution1"]),
                                    n + 1)))
    return [int(v) for v in r[1:]]


def upsample(before: dict, density_grid: torch.Tensor, res_next: int, cfg: dict,
             precision: str = "f32") -> dict:
    """The factors after a shrink and upsample from `before` (`weights`,
    `resolution` (x, y, z) and `aabb`, None for the cube), on the density
    grid `density_grid` [H^3] (cell (x, y, z) at (x H + y) H + z), towards
    `res_next` voxels a side.  Returns dict(weights, resolution, aabb); the
    control (`precision="low"`) interpolates in bfloat16."""
    q = bf16 if precision == "low" else same
    H, b = cfg["render"]["grid_size"], cfg["bound"]
    g = density_grid.reshape(-1).float()
    thresh = min(float(torch.clamp(g, min=0.0).mean()), cfg["render"]["density_thresh"])
    occ = torch.nonzero(g.reshape(H, H, H) > thresh).cpu().numpy()
    box = np.asarray(before["aabb"] or [-b] * 3 + [b] * 3, np.float32)
    res = np.asarray(before["resolution"])
    if len(occ) == 0:
        lo, hi = box[:3].astype(np.float64), box[3:].astype(np.float64)
        tl, br = np.zeros(3, int), res
    else:
        half = b / H
        pos = (2.0 * occ / (H - 1) - 1.0) * (b - half)
        lo, hi = pos.min(0) - half, pos.max(0) + half
        unit = (box[3:] - box[:3]) / res
        tl = np.maximum(np.round((lo - box[:3]) / unit).astype(int), 0)
        br = np.minimum(np.round((hi - box[:3]) / unit).astype(int), res)
    vox = np.cbrt(np.prod(hi - lo) / res_next ** 3)
    new = [int(v) for v in ((hi - lo) / vox).astype(np.int32)]
    out = {}
    for k, v in before["weights"].items():
        v = v.float()
        if "_mat_" in k:
            m0, m1 = MAT_IDS[int(k[-1])]
            v = v[:, tl[m1]:br[m1], tl[m0]:br[m0]]
            v = resize_linear(resize_linear(v, new[m1], 1, q), new[m0], 2, q)
        elif "_vec_" in k:
            a = VEC_IDS[int(k[-1])]
            v = resize_linear(v[:, tl[a]:br[a]], new[a], 1, q)
        out[k] = v
    return {"weights": out, "resolution": new, "aabb": [float(x) for x in np.concatenate([lo, hi])]}


def stage_numbers(seen: dict, cfg: dict, precision: str = "f32") -> dict:
    """The last upsample (`seen`: the program's state before and after it,
    and the density grid it shrank by) against `upsample` from the same
    state: `upsample_off`, the axes whose resolution and the box's
    coordinates that differ, and `upsample_gap`, the worst factor's
    largest gap over its largest |value| (1.0 where the shapes differ)."""
    if not seen:
        return {}
    got = upsample(seen["before"], seen["density_grid"],
                   upsample_resolutions(cfg)[seen["milestone"]], cfg, precision)
    prog = seen["after"]
    off = sum(int(a != b) for a, b in zip(got["resolution"], prog["resolution"]))
    off += sum(int(abs(a - b) > 1e-9) for a, b in zip(got["aabb"], prog["aabb"] or []))
    gap = 0.0
    for k, v in got["weights"].items():
        p = prog["weights"][k].float()
        if p.shape != v.shape:
            gap = max(gap, 1.0)
            continue
        gap = max(gap, float((p - v).abs().max()) / max(float(v.abs().max()), 1e-30))
    return {"upsample_off": off, "upsample_gap": gap}
