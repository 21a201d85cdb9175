"""CCNeRF: the rank-residual compressible and composable tensor radiance
field — the port of `tngp/models/ccnerf.py`.

- `CCConfig`: the static structure of one object (resolution, SH degree,
  the cumulative ranks of its K groups for density and colour, vector and
  matrix factors), with the JAX package's fields and defaults.
- `cc_init`: the parameter dict of one object — per non-empty group g,
  `{kind}_U_{g}` (three factors: lines [r, D] for "vd"/"vc", planes
  [r, H, W] for "md"/"mc") and `{kind}_S_{g}` [out, r] — from the JAX
  package's init distributions with a seed.
- `CCNeRF(cfg, params)`: the field as an `nn.Module` holding that dict
  (`{kind}_U_{g}` a `ParameterList`, so state-dict names are `vd_U_0.0`,
  ..., as the flax state dict flattens the lists).  `sigma_h_cf(x, d, K,
  residual)` gives the pre-sigmoid outputs, `residual=True` the K
  cumulative prefixes [K, B] / [K, 3, B]; `sigma_rgb_cf` and `density_cf`
  are the field interface.  Grid samples use `align_corners=False`; a
  matrix group's feature is the product of three planes; a group of rank 0
  is absent and carries the previous cumulative output through.  Each
  factor's gradient is one `scatter_add_any` launch on the card.
- `cc_finalize` / `cc_compress`: host-side numpy surgery (sort each group's
  ranks by importance, fuse the groups; prefix-slice to given ranks),
  line for line the JAX package's, so the same inputs give the same arrays.
- `CCScene`: finalized objects with world -> object transforms; densities
  summed, colours softmax(sigma)-weighted before the sigmoid.
- `load_cc_model` / `save_cc_model`: the `(params, CCConfig)` pickles of
  `main_ccnerf`'s `<workspace>/cc_models/`.  A file the JAX package wrote
  names `tngp.models.ccnerf.CCConfig`; the reader maps that one class (and
  the port's own) to this module's `CCConfig` and refuses every other class
  outside numpy.  Files written here name the port's class, which the JAX
  package cannot import.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field, replace
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.activation import trunc_exp
from ..ops.grid_sample import grid_sample_1d_cf_vjp, grid_sample_2d_cf_vjp
from ..ops.sh import sh_encode_cf
from .tensorf import MAT_IDS, VEC_IDS

KINDS = ("vd", "md", "vc", "mc")  # density vec / mat, colour vec / mat


@dataclass(frozen=True)
class CCConfig:
    """Static structure of one CCNeRF object (group ranks etc.)."""

    resolution: Tuple[int, int, int] = (128, 128, 128)
    degree: int = 4
    rank_vec_density: Tuple[int, ...] = (64, 64, 64, 64, 64)
    rank_mat_density: Tuple[int, ...] = (0, 4, 8, 12, 16)
    rank_vec: Tuple[int, ...] = (64, 64, 64, 64, 64)
    rank_mat: Tuple[int, ...] = (0, 4, 16, 32, 64)
    bound: float = 1.0

    @property
    def K(self) -> int:
        return len(self.rank_vec)

    @property
    def out_dim(self) -> int:
        return 3 * self.degree**2

    def groups(self, ranks: Tuple[int, ...]) -> List[int]:
        return list(np.diff(np.asarray(ranks), prepend=0))

    def ranks(self, kind: str) -> Tuple[int, ...]:
        return {"vd": self.rank_vec_density, "md": self.rank_mat_density,
                "vc": self.rank_vec, "mc": self.rank_mat}[kind]


def _shape_kind(kind: str) -> str:
    return "vec" if kind in ("vd", "vc") else "mat"


def cc_init(cfg: CCConfig, seed: int = 0) -> dict:
    """The parameter dict of one un-finalized object, numpy float32: U
    factors N(0, 1) * 0.2, S by kaiming-normal (std sqrt(2 / r))."""
    gen = torch.Generator().manual_seed(seed)
    res = cfg.resolution
    params = {}
    for kind in KINDS:
        out_dim = 1 if kind in ("vd", "md") else cfg.out_dim
        for g, r in enumerate(cfg.groups(cfg.ranks(kind))):
            r = int(r)
            if r <= 0:
                continue
            us = []
            for i in range(3):
                if _shape_kind(kind) == "vec":
                    shape = (r, res[VEC_IDS[i]])
                else:
                    m0, m1 = MAT_IDS[i]
                    shape = (r, res[m1], res[m0])
                us.append((0.2 * torch.randn(shape, generator=gen)).numpy())
            params[f"{kind}_U_{g}"] = us
            params[f"{kind}_S_{g}"] = (torch.randn((out_dim, r), generator=gen)
                                       * np.sqrt(2.0 / r)).float().numpy()
    return params


def _group_feat(us, x_cf: torch.Tensor, shape_kind: str) -> torch.Tensor:
    """Triple product of the three factor lookups -> [r, B]."""
    if shape_kind == "vec":
        f = grid_sample_1d_cf_vjp(us[0], x_cf[VEC_IDS[0]], align_corners=False)
        for i in (1, 2):
            f = f * grid_sample_1d_cf_vjp(us[i], x_cf[VEC_IDS[i]], align_corners=False)
        return f
    f = None
    for i in range(3):
        m0, m1 = MAT_IDS[i]
        fi = grid_sample_2d_cf_vjp(us[i], x_cf[m0], x_cf[m1], align_corners=False)
        f = fi if f is None else f * fi
    return f


class CCNeRF(nn.Module):
    """One CCNeRF object's field (module docstring).  `params` (a
    `cc_init`-shaped dict of arrays) gives the weights; None draws them
    with `cc_init(cfg, seed)`."""

    bg_radius = -1.0  # no background model

    def __init__(self, cfg: CCConfig, params: Optional[Mapping] = None, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        params = cc_init(cfg, seed) if params is None else params

        def param(a):
            return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)).to(device))

        for name, value in params.items():
            if isinstance(value, (list, tuple)):
                self.register_module(name, nn.ParameterList([param(u) for u in value]))
            else:
                self.register_parameter(name, param(value))

    def numpy_params(self) -> dict:
        """The parameter dict as numpy arrays on the host (factor lists as lists)."""
        out = {}
        for name, value in self.named_children():
            out[name] = [u.detach().cpu().numpy().copy() for u in value]
        for name, value in self.named_parameters(recurse=False):
            out[name] = value.detach().cpu().numpy().copy()
        return out

    def _compute(self, x_cf: torch.Tensor, kinds, K: int, residual: bool):
        """Cumulative group outputs: [K, out, B] if residual else [out, B]."""
        outs = []
        last = None
        for g in range(K):
            y = None
            for kind in kinds:
                if not hasattr(self, f"{kind}_U_{g}"):
                    continue
                feat = _group_feat(getattr(self, f"{kind}_U_{g}"), x_cf, _shape_kind(kind))
                contrib = getattr(self, f"{kind}_S_{g}") @ feat  # [out, B]
                y = contrib if y is None else y + contrib
            if y is None:
                y = torch.zeros_like(last) if last is not None else None
            if last is not None and y is not None:
                y = y + last
            last = y
            if residual:
                outs.append(y)
        return torch.stack(outs, dim=0) if residual else last

    def sigma_h_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor, K: int = -1,
                   residual: bool = False):
        """Pre-sigmoid outputs: sigma [(K,) B], h [(K,) 3, B]; x in
        [-bound, bound]."""
        cfg = self.cfg
        if K <= 0:
            K = cfg.K
        xn = x_cf / cfg.bound
        dens = self._compute(xn, ("vd", "md"), K, residual)  # [(K,) 1, B]
        enc_d = sh_encode_cf(d_cf, cfg.degree)  # [deg^2, B]
        col = self._compute(xn, ("vc", "mc"), K, residual)  # [(K,) 3 deg^2, B]
        if residual:
            sigma = trunc_exp(dens[:, 0, :])
            h = col.reshape(K, 3, cfg.degree**2, x_cf.shape[1])
            h = (h * enc_d[None, None]).sum(dim=2)  # [K, 3, B]
        else:
            sigma = trunc_exp(dens[0])
            h = col.reshape(3, cfg.degree**2, -1)
            h = (h * enc_d[None]).sum(dim=1)  # [3, B]
        return sigma, h

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor, K: int = -1,
                     residual: bool = False):
        """sigma [(K,) B], rgb [(K,) 3, B]."""
        sigma, h = self.sigma_h_cf(x_cf, d_cf, K, residual)
        return sigma, torch.sigmoid(h)

    def density_cf(self, x_cf: torch.Tensor):
        dens = self._compute(x_cf / self.cfg.bound, ("vd", "md"), self.cfg.K, False)
        return {"sigma": trunc_exp(dens[0]), "geo_feat": None}


# ---- host-side parameter surgery --------------------------------------------


def _np(params: Mapping) -> dict:
    return {k: ([np.asarray(u) for u in v] if isinstance(v, (list, tuple)) else np.asarray(v))
            for k, v in params.items()}


def cc_finalize(params: Mapping, cfg: CCConfig) -> Tuple[dict, CCConfig]:
    """Sort ranks by importance within each group, then fuse all groups into
    one (network_cc.py:462-516)."""
    p = _np(params)
    out = {}
    for kind, ranks in (
        ("vd", cfg.rank_vec_density), ("md", cfg.rank_mat_density),
        ("vc", cfg.rank_vec), ("mc", cfg.rank_mat),
    ):
        us_all, s_all = [[], [], []], []
        for g in range(cfg.K):
            if f"{kind}_U_{g}" not in p:
                continue
            us = p[f"{kind}_U_{g}"]
            S = p[f"{kind}_S_{g}"]
            importance = np.abs(S).sum(0)
            for j in range(3):
                importance = importance * np.linalg.norm(
                    us[j].reshape(us[j].shape[0], -1), axis=-1
                )
            inds = np.argsort(-importance)
            s_all.append(S[:, inds])
            for j in range(3):
                us_all[j].append(us[j][inds])
        if s_all:
            out[f"{kind}_U_0"] = [np.concatenate(u, axis=0) for u in us_all]
            out[f"{kind}_S_0"] = np.concatenate(s_all, axis=1)
    new_cfg = replace(
        cfg,
        rank_vec_density=(cfg.rank_vec_density[-1],),
        rank_mat_density=(cfg.rank_mat_density[-1],),
        rank_vec=(cfg.rank_vec[-1],),
        rank_mat=(cfg.rank_mat[-1],),
    )
    return out, new_cfg


def cc_compress(params: Mapping, cfg: CCConfig, ranks: Sequence[int]) -> Tuple[dict, CCConfig]:
    """Prefix-slice a finalized model to (density_vec, density_mat, color_vec,
    color_mat) ranks (network_cc.py:520-549)."""
    if cfg.K != 1:
        params, cfg = cc_finalize(params, cfg)
    p = _np(params)
    out = {}
    for kind, rank in zip(KINDS, ranks):
        if rank <= 0 or f"{kind}_U_0" not in p:
            continue
        out[f"{kind}_U_0"] = [u[:rank].copy() for u in p[f"{kind}_U_0"]]
        out[f"{kind}_S_0"] = p[f"{kind}_S_0"][:, :rank].copy()
    new_cfg = replace(
        cfg,
        rank_vec_density=(int(ranks[0]),), rank_mat_density=(int(ranks[1]),),
        rank_vec=(int(ranks[2]),), rank_mat=(int(ranks[3]),),
    )
    return out, new_cfg


def count_params(params: Mapping) -> int:
    return sum(int(np.asarray(u).size) for v in params.values()
               for u in (v if isinstance(v, (list, tuple)) else [v]))


def _apply_3x4(T: torch.Tensor, x_cf: torch.Tensor) -> torch.Tensor:
    """T[:3, :3] @ x + T[:3, 3] as f32 elementwise products (no matmul, so
    no TF32 on the card)."""
    return (T[:3, 0:1] * x_cf[0] + T[:3, 1:2] * x_cf[1] + T[:3, 2:3] * x_cf[2]) + T[:3, 3:4]


@dataclass
class CCScene:
    """A composed scene of finalized objects with per-object transforms
    (network_cc.py compose/:551-624)."""

    device: str = "cuda"
    objects: List[CCNeRF] = field(default_factory=list)
    transforms: List[torch.Tensor] = field(default_factory=list)  # [4, 4] world -> object
    rotations: List[torch.Tensor] = field(default_factory=list)  # [3, 3] direction rotation

    def add(self, params: Mapping, cfg: CCConfig, R=None, s: float = 1.0, t=None):
        if cfg.K != 1:
            params, cfg = cc_finalize(params, cfg)
        R = np.eye(3, dtype=np.float32) if R is None else np.asarray(R, np.float32)
        t = np.zeros(3, np.float32) if t is None else np.asarray(t, np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R * s
        T[:3, 3] = t
        self.objects.append(CCNeRF(cfg, params, device=self.device))
        self.transforms.append(torch.as_tensor(np.linalg.inv(T), device=self.device))
        Rt = np.zeros((3, 4), np.float32)
        Rt[:, :3] = R.T
        self.rotations.append(torch.as_tensor(Rt, device=self.device))
        return self

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor):
        """Sum of densities; softmax(sigma)-weighted pre-sigmoid colours,
        then the sigmoid (network_cc.py:297-335)."""
        sigmas, hs = [], []
        for obj, T, Rr in zip(self.objects, self.transforms, self.rotations):
            sig, h = obj.sigma_h_cf(_apply_3x4(T, x_cf), _apply_3x4(Rr, d_cf), K=1)
            sigmas.append(sig)
            hs.append(h)
        sig_all = sum(sigmas)
        ws = torch.softmax(torch.stack(sigmas, dim=0), dim=0)  # [O, B]
        rgb_all = torch.sigmoid(sum(h * w[None] for h, w in zip(hs, ws)))
        return sig_all, rgb_all

    def density_cf(self, x_cf: torch.Tensor):
        total = None
        for obj, T in zip(self.objects, self.transforms):
            s = obj.density_cf(_apply_3x4(T, x_cf))["sigma"]
            total = s if total is None else total + s
        return {"sigma": total, "geo_feat": None}


# ---- cc_models pickles --------------------------------------------------------

_CC_CONFIG_CLASSES = {("tngp.models.ccnerf", "CCConfig"), ("tngp_torch.models.ccnerf", "CCConfig")}


class _CCUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CC_CONFIG_CLASSES:
            return CCConfig
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"cc_models file names {module}.{name}: refused")


def load_cc_model(path: str) -> Tuple[dict, CCConfig]:
    """(params, CCConfig) from a `cc_models` pickle of either package."""
    with open(path, "rb") as f:
        params, cfg = _CCUnpickler(f).load()
    return _np(params), cfg


def save_cc_model(path: str, params: Mapping, cfg: CCConfig) -> None:
    """Write (params, CCConfig) as the JAX package lays it out (module
    docstring: the class is the port's)."""
    with open(path, "wb") as f:
        pickle.dump((_np(params), cfg), f)
