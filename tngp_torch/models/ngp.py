"""Instant-NGP NeRF field network — the port of `tngp/models/ngp.py`
`NGPNetwork`.

hash-grid encode -> 2x64 bias-free MLP -> (sigma = trunc_exp, 15 geo
features); SH(dir) ++ geo features ++ one zero pad -> 3x64 MLP -> sigmoid.
With `bg_radius > 0`, the background model: a 2-D hash grid over the
background sphere's coordinates (4 levels, 2^19 rows, resolution 2048)
after SH(dir) -> 2x64 MLP -> sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from ..encoders import get_encoder
from ..ops.activation import trunc_exp
from .common import MLP


class NGPNetwork(nn.Module):
    """Parameters are named as the flax module's (`encoder.embeddings`,
    `sigma_net.dense_i`, `color_net.dense_i`, and with the background
    `encoder_bg.embeddings`, `bg_net.dense_i`), so `convert.py` maps a flax
    param tree onto `state_dict` keys one to one.  The defaults are the JAX
    module's (the golden `hashgrid` encoder).  Initial weights are drawn
    from the JAX package's init distributions with `seed`."""

    def __init__(
        self,
        bound: float = 1.0,
        encoding: str = "hashgrid",
        encoding_dir: str = "sphere_harmonics",
        encoding_bg: str = "hashgrid",
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        num_layers_bg: int = 2,
        hidden_dim_bg: int = 64,
        bg_radius: float = -1.0,
        log2_hashmap_size: int = 19,
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.bound = bound
        self.bg_radius = bg_radius
        self.geo_feat_dim = geo_feat_dim
        self.encoder, in_dim = get_encoder(
            encoding,
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=int(2048 * bound),
            # positions come from the march and are never differentiated
            input_grad=False,
            device=device,
            generator=gen,
        )
        self.sigma_net = MLP(in_dim, hidden_dim, 1 + geo_feat_dim, num_layers,
                             compute_dtype, device, gen)
        self.encoder_dir, in_dim_dir = get_encoder(encoding_dir)
        self.color_net = MLP(in_dim_dir + geo_feat_dim + 1, hidden_dim_color, 3,
                             num_layers_color, compute_dtype, device, gen)
        if bg_radius > 0:
            self.encoder_bg, in_dim_bg = get_encoder(
                encoding_bg, input_dim=2, num_levels=4, log2_hashmap_size=19,
                desired_resolution=2048,
                input_grad=False,  # sphere coordinates are not differentiated
                device=device, generator=gen,
            )
            self.bg_net = MLP(in_dim_dir + in_dim_bg, hidden_dim_bg, 3, num_layers_bg,
                              compute_dtype, device, gen)

    def density_cf(self, x_cf: torch.Tensor):
        """x_cf [3, B] in [-bound, bound] -> {'sigma': [B], 'geo_feat': [15, B]}"""
        h = self.encoder.cf(x_cf, bound=self.bound)  # [L*C, B]
        h = self.sigma_net.cf(h)  # [16, B]
        return {"sigma": trunc_exp(h[0].float()), "geo_feat": h[1:]}

    def color_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor,
                 geo_feat: torch.Tensor) -> torch.Tensor:
        de = self.encoder_dir.cf(d_cf)  # [16, B]
        pad = torch.zeros_like(geo_feat[:1])  # color input padded to 32
        h = torch.cat([de.to(geo_feat.dtype), geo_feat, pad], dim=0)
        return torch.sigmoid(self.color_net.cf(h).float())  # [3, B]

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor):
        out = self.density_cf(x_cf)
        return out["sigma"], self.color_cf(x_cf, d_cf, out["geo_feat"])

    def background_cf(self, sph_cf: torch.Tensor, d_cf: torch.Tensor) -> torch.Tensor:
        """sph_cf [2, B] sphere coordinates in [-1, 1], d_cf [3, B] -> rgb [3, B]."""
        return _background_cf(self, sph_cf, d_cf)

    def background(self, sph: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Batch-first: sph [..., 2], d [..., 3] -> rgb [..., 3]."""
        prefix = sph.shape[:-1]
        rgb = self.background_cf(sph.reshape(-1, 2).T, d.reshape(-1, 3).T)
        return rgb.T.reshape(*prefix, 3)


def _background_cf(model: nn.Module, sph_cf: torch.Tensor, d_cf: torch.Tensor) -> torch.Tensor:
    """The background model of NGP and D-NeRF: enc_bg(sph) after SH(dir)
    -> bg MLP -> sigmoid."""
    h = model.encoder_bg.cf(sph_cf, bound=1.0)
    de = model.encoder_dir.cf(d_cf)
    h = torch.cat([de.to(h.dtype), h], dim=0)
    return torch.sigmoid(model.bg_net.cf(h).float())
