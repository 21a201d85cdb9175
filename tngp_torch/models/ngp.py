"""Instant-NGP NeRF field network — the port of `tngp/models/ngp.py`
`NGPNetwork` without the background model.

hash-grid encode -> 2x64 bias-free MLP -> (sigma = trunc_exp, 15 geo
features); SH(dir) ++ geo features ++ one zero pad -> 3x64 MLP -> sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from ..encoders import get_encoder
from ..ops.activation import trunc_exp
from .common import MLP


class NGPNetwork(nn.Module):
    """Parameters are named as the flax module's (`encoder.embeddings`,
    `sigma_net.dense_i`, `color_net.dense_i`), so `convert.py` maps a flax
    param tree onto `state_dict` keys one to one.  Initial weights are drawn
    from the JAX package's init distributions with `seed`."""

    def __init__(
        self,
        bound: float = 1.0,
        encoding: str = "hashgrid_window",
        encoding_dir: str = "sphere_harmonics",
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
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
        if bg_radius > 0:
            raise NotImplementedError("the background model is not ported yet")
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
            device=device,
            generator=gen,
        )
        self.sigma_net = MLP(in_dim, hidden_dim, 1 + geo_feat_dim, num_layers,
                             compute_dtype, device, gen)
        self.encoder_dir, in_dim_dir = get_encoder(encoding_dir)
        self.color_net = MLP(in_dim_dir + geo_feat_dim + 1, hidden_dim_color, 3,
                             num_layers_color, compute_dtype, device, gen)

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
