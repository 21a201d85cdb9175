"""TensoRF field networks, VM (vector-matrix) and CP (rank-1) — the port of
`tngp/models/tensorf.py`.

- density: sum over the three axis pairings (planes `MAT_IDS`, lines
  `VEC_IDS`) of <plane_i(x), line_i(x)> (VM), or the sum of the rank-1
  products of three lines (CP), through `trunc_exp`;
- colour: `basis_mat` over the pairings' plane * line features (VM: their
  concatenation; CP: the product) -> freq-encode (2 octaves) ++ freq(dir,
  2) -> 3x128 bias-free MLP -> sigmoid;
- positions are normalised to [-1, 1] by the shrinkable `aabb` (the cube
  [-bound, bound] while it is empty);
- with `bg_radius > 0` a background plane `bg_mat` [bg_rank, 512, 512]
  sampled at the background sphere's coordinates, ++ freq(dir, 2) -> 2x64
  MLP -> sigmoid.

Every lookup goes through `ops/grid_sample.py`'s VJP variants, so on the
card each factor's gradient is one `scatter_add_any` launch: 12 a VM step
(6 planes, 6 lines), 6 a CP step, one more for the background plane.

Parameters carry the flax names (`sigma_mat_i`, `sigma_vec_i`,
`color_mat_i`, `color_vec_i`, `basis_mat`, `color_net.dense_i`, `bg_mat`,
`bg_net.dense_i`); the L1 loss selects the `sigma_` ones.  Initial weights
are drawn from the JAX package's distributions with `seed`.

`shrink_params` and `upsample_params` are host-side functions of a
`{name: numpy array}` state dict, as the JAX package's are of its flax tree;
`TensoRFNetwork.clone` makes the module of the new shape.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.activation import trunc_exp
from ..ops.freq import freq_encode_cf
from ..ops.grid_sample import grid_sample_1d_cf_vjp, grid_sample_2d_cf_vjp
from .common import MLP

MAT_IDS = ((0, 1), (0, 2), (1, 2))
VEC_IDS = (2, 1, 0)
FREQ = 2  # octaves of the colour features' and the directions' encodings


class TensoRFNetwork(nn.Module):
    """VM (`decomposition="vm"`) or CP (`"cp"`) TensoRF field.  The
    constructor's arguments and defaults are the flax module's; `aabb=()`
    is the cube [-bound, bound]."""

    def __init__(
        self,
        resolution: Sequence[int] = (128, 128, 128),
        sigma_rank: Sequence[int] = (16, 16, 16),
        color_rank: Sequence[int] = (48, 48, 48),
        color_feat_dim: int = 27,
        num_layers: int = 3,
        hidden_dim: int = 128,
        bound: float = 1.0,
        aabb: Sequence[float] = (),
        decomposition: str = "vm",
        bg_radius: float = -1.0,
        bg_resolution: Sequence[int] = (512, 512),
        bg_rank: int = 8,
        num_layers_bg: int = 2,
        hidden_dim_bg: int = 64,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        if decomposition not in ("vm", "cp"):
            raise ValueError(f"decomposition must be 'vm' or 'cp', got {decomposition!r}")
        self.config = dict(
            resolution=tuple(int(r) for r in resolution), sigma_rank=tuple(sigma_rank),
            color_rank=tuple(color_rank), color_feat_dim=color_feat_dim,
            num_layers=num_layers, hidden_dim=hidden_dim, bound=bound,
            aabb=tuple(float(a) for a in aabb), decomposition=decomposition,
            bg_radius=bg_radius, bg_resolution=tuple(bg_resolution), bg_rank=bg_rank,
            num_layers_bg=num_layers_bg, hidden_dim_bg=hidden_dim_bg,
            compute_dtype=compute_dtype)
        self.device_, self.seed = device, seed
        for k, v in self.config.items():
            setattr(self, k, v)
        gen = torch.Generator().manual_seed(seed)
        res = self.resolution

        def factor(*shape):
            t = torch.randn(shape, generator=gen, dtype=torch.float32) * 0.1
            return nn.Parameter(t.to(device))

        if decomposition == "vm":
            for kind, rank in (("sigma", sigma_rank), ("color", color_rank)):
                for i in range(3):
                    m0, m1 = MAT_IDS[i]
                    self.register_parameter(f"{kind}_mat_{i}",
                                            factor(rank[i], res[m1], res[m0]))
        for kind, rank in (("sigma", sigma_rank), ("color", color_rank)):
            for i in range(3):
                self.register_parameter(f"{kind}_vec_{i}", factor(rank[i], res[VEC_IDS[i]]))
        basis_in = sum(color_rank) if decomposition == "vm" else color_rank[0]
        u = torch.rand((basis_in, color_feat_dim), generator=gen, dtype=torch.float32)
        self.basis_mat = nn.Parameter(((u * 2.0 - 1.0) / math.sqrt(basis_in)).to(device))
        enc_dir = 3 * (1 + 2 * FREQ)
        self.color_net = MLP(color_feat_dim * (1 + 2 * FREQ) + enc_dir, hidden_dim, 3,
                             num_layers, compute_dtype, device, gen)
        if bg_radius > 0:
            self.bg_mat = factor(bg_rank, bg_resolution[0], bg_resolution[1])
            self.bg_net = MLP(bg_rank + enc_dir, hidden_dim_bg, 3, num_layers_bg,
                              compute_dtype, device, gen)

    def clone(self, **overrides) -> "TensoRFNetwork":
        """A module of the same configuration with `overrides` (the flax
        `clone`), on the same device, freshly initialised."""
        return TensoRFNetwork(**{**self.config, **overrides}, device=self.device_,
                              seed=self.seed)

    def _factors(self, kind: str, what: str):
        return [getattr(self, f"{kind}_{what}_{i}") for i in range(3)]

    # ---- factor lookups (x normalised to [-1, 1]) --------------------------
    def _normalize(self, x_cf: torch.Tensor) -> torch.Tensor:
        b = self.bound
        aabb = self.aabb or (-b,) * 3 + (b,) * 3
        lo = torch.tensor(aabb[:3], dtype=torch.float32, device=x_cf.device)[:, None]
        hi = torch.tensor(aabb[3:], dtype=torch.float32, device=x_cf.device)[:, None]
        return 2.0 * (x_cf - lo) / (hi - lo) - 1.0

    def _pair_feat(self, kind: str, xn: torch.Tensor):
        feats = []
        for i, (mat, vec) in enumerate(zip(self._factors(kind, "mat"),
                                           self._factors(kind, "vec"))):
            m0, m1 = MAT_IDS[i]
            mat_f = grid_sample_2d_cf_vjp(mat, xn[m0], xn[m1])
            vec_f = grid_sample_1d_cf_vjp(vec, xn[VEC_IDS[i]])
            feats.append(mat_f * vec_f)  # [R_i, B]
        return feats

    def _cp_prod(self, kind: str, xn: torch.Tensor) -> torch.Tensor:
        vecs = self._factors(kind, "vec")
        f = grid_sample_1d_cf_vjp(vecs[0], xn[VEC_IDS[0]])
        for i in (1, 2):
            f = f * grid_sample_1d_cf_vjp(vecs[i], xn[VEC_IDS[i]])
        return f  # [R, B]

    def sigma_feat_cf(self, xn: torch.Tensor) -> torch.Tensor:
        if self.decomposition == "cp":
            return self._cp_prod("sigma", xn).sum(dim=0)
        feats = self._pair_feat("sigma", xn)
        return feats[0].sum(dim=0) + feats[1].sum(dim=0) + feats[2].sum(dim=0)

    def color_feat_cf(self, xn: torch.Tensor) -> torch.Tensor:
        if self.decomposition == "cp":
            cat = self._cp_prod("color", xn)
        else:
            cat = torch.cat(self._pair_feat("color", xn), dim=0)  # [3R, B]
        return self.basis_mat.T @ cat  # [feat_dim, B]

    # ---- field interface ---------------------------------------------------
    def density_cf(self, x_cf: torch.Tensor):
        sigma = trunc_exp(self.sigma_feat_cf(self._normalize(x_cf)))
        return {"sigma": sigma, "geo_feat": None}

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor):
        """x_cf [3, B] in [-bound, bound], d_cf [3, B] -> (sigma [B], rgb [3, B])."""
        xn = self._normalize(x_cf)
        sigma = trunc_exp(self.sigma_feat_cf(xn))
        h = torch.cat([freq_encode_cf(self.color_feat_cf(xn), FREQ),
                       freq_encode_cf(d_cf.float(), FREQ)], dim=0)
        return sigma, torch.sigmoid(self.color_net.cf(h).float())

    def background_cf(self, sph_cf: torch.Tensor, d_cf: torch.Tensor) -> torch.Tensor:
        """sph_cf [2, B] background-sphere coordinates, d_cf [3, B] -> rgb [3, B]."""
        h = grid_sample_2d_cf_vjp(self.bg_mat, sph_cf[0], sph_cf[1])  # [bg_rank, B]
        h = torch.cat([h, freq_encode_cf(d_cf.float(), FREQ)], dim=0)
        return torch.sigmoid(self.bg_net.cf(h).float())

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        """Batch-first: x, d [..., 3] -> (sigma [...], rgb [..., 3])."""
        prefix = x.shape[:-1]
        sigma, rgb = self.sigma_rgb_cf(x.reshape(-1, 3).T, d.reshape(-1, 3).T)
        return sigma.reshape(prefix), rgb.T.reshape(*prefix, 3)


def l1_density_loss(model: nn.Module) -> torch.Tensor:
    """Mean |.| over the density factor grids, averaged over the grids
    (`tngp/train/tensorf_trainer.py:31-35`)."""
    terms = [p.abs().mean() for n, p in model.named_parameters() if n.startswith("sigma_")]
    return sum(terms) / max(len(terms), 1)


# ---- progressive upsampling / shrinking (host-side state-dict transforms) --


def jnp_linspace_f32(stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(0.0, stop, num)` in float32, bit for bit, as XLA's CPU
    compiles it: the JAX program's `stop * (iota / (num - 1))` becomes
    `iota * (stop * (1 / (num - 1)))` (the division by a constant turned
    into a product by its f32 reciprocal, the two constants folded), then
    `stop` is appended.  torch.linspace and numpy's float32 linspace round
    differently (`tests/test_torch_tensorf_resize.py` holds the cases)."""
    if num == 1:
        return np.zeros(1, np.float32)
    k = np.float32(stop) * (np.float32(1) / np.float32(num - 1))
    out = np.arange(num - 1, dtype=np.float32) * np.float32(k)
    return np.concatenate([out, np.array([stop], np.float32)])


def _resize_linear(arr: np.ndarray, new_len: int, axis: int) -> np.ndarray:
    """1-D linear resize along `axis` (align_corners=True), in float32 as
    the JAX package's eager jnp ops compute it."""
    a = np.moveaxis(np.asarray(arr, np.float32), axis, -1)
    old = a.shape[-1]
    pos = jnp_linspace_f32(old - 1.0, new_len)
    i0 = np.clip(np.floor(pos).astype(np.int32), 0, old - 1)
    i1 = np.clip(i0 + 1, 0, old - 1)
    t = pos - i0.astype(np.float32)
    out = a[..., i0] * (np.float32(1) - t) + a[..., i1] * t
    return np.moveaxis(out, -1, axis)


def shrink_params(params: Mapping[str, np.ndarray], model: TensoRFNetwork,
                  density_grid_coarsest, grid_size: int, thresh: float):
    """Crop the factor grids to the occupied box of the coarsest cascade's
    density grid (`[H^3]`, linear order ix-major).  Returns (new params, new
    module) — the module freshly initialised at the cropped resolution with
    the new `aabb`; the caller loads the params.  Unchanged when no cell is
    above `thresh`.  The arithmetic is `tngp/models/tensorf.py:196-242`'s
    numpy, line for line."""
    g = np.asarray(density_grid_coarsest).reshape(grid_size, grid_size, grid_size)
    occ = np.argwhere(g > thresh)  # [Nz, 3] (ix, iy, iz)
    bound = model.bound
    aabb_old = np.asarray(model.aabb or (-bound,) * 3 + (bound,) * 3, np.float32)
    if len(occ) == 0:
        return dict(params), model
    half = bound / grid_size
    pos = (2 * occ / (grid_size - 1) - 1) * (bound - half)
    min_pos = pos.min(0) - half
    max_pos = pos.max(0) + half

    reso = np.asarray(model.resolution)
    units = (aabb_old[3:] - aabb_old[:3]) / reso
    tl = np.clip(np.round((min_pos - aabb_old[:3]) / units).astype(int), 0, None)
    br = np.minimum(np.round((max_pos - aabb_old[:3]) / units).astype(int), reso)

    out = {}
    for name, leaf in params.items():
        if name.startswith(("sigma_vec_", "color_vec_")):
            v = VEC_IDS[int(name[-1])]
            leaf = leaf[:, tl[v]:br[v]]
        elif name.startswith(("sigma_mat_", "color_mat_")):
            m0, m1 = MAT_IDS[int(name[-1])]
            leaf = leaf[:, tl[m1]:br[m1], tl[m0]:br[m0]]
        out[name] = np.ascontiguousarray(leaf)
    new_res = tuple(int(b - t) for t, b in zip(tl, br))
    new_model = model.clone(resolution=new_res,
                            aabb=tuple(np.concatenate([min_pos, max_pos]).astype(float)))
    return out, new_model


def upsample_params(params: Mapping[str, np.ndarray], new_resolution: Sequence[int]) -> dict:
    """Linearly resize every VM / CP factor to `new_resolution` (planes along
    both axes, height first); other entries pass through."""
    res = tuple(new_resolution)
    out = {}
    for name, leaf in params.items():
        if name.startswith(("sigma_mat_", "color_mat_")):
            m0, m1 = MAT_IDS[int(name[-1])]
            leaf = _resize_linear(leaf, res[m1], axis=1)
            leaf = _resize_linear(leaf, res[m0], axis=2)
        elif name.startswith(("sigma_vec_", "color_vec_")):
            leaf = _resize_linear(leaf, res[VEC_IDS[int(name[-1])]], axis=1)
        out[name] = np.ascontiguousarray(leaf)
    return out


def numpy_state(model: nn.Module) -> dict:
    """{name: float32 numpy array} of a module's parameters, on the host."""
    return {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


def load_numpy_state(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy `params` into the module's parameters (shapes must match)."""
    named = dict(model.named_parameters())
    with torch.no_grad():
        for n, v in params.items():
            named[n].copy_(torch.as_tensor(np.asarray(v, np.float32)))
    return model
