"""SDF field network — the port of `tngp/models/sdf.py` `SDFNetwork`.

hash-grid encode (16 levels x 2 features, 2^19 rows a level from base
resolution 16 to 2048: 6,119,864 rows in all) -> 3x64 bias-free MLP ->
signed distance, optionally clamped to +-clip_sdf.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..encoders import get_encoder
from .common import MLP


class SDFNetwork(nn.Module):
    """Parameters are named as the flax module's (`encoder.embeddings`,
    `backbone.dense_i`), so `convert.py` maps a flax tree onto `state_dict`
    keys one to one.  Initial weights are drawn from the JAX package's init
    distributions with `seed`."""

    def __init__(
        self,
        encoding: str = "hashgrid",
        num_layers: int = 3,
        hidden_dim: int = 64,
        clip_sdf: Optional[float] = None,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.clip_sdf = clip_sdf
        self.encoder, in_dim = get_encoder(encoding, desired_resolution=2048, device=device,
                                           generator=gen)
        self.backbone = MLP(in_dim, hidden_dim, 1, num_layers, compute_dtype, device, gen)

    def cf(self, x_cf: torch.Tensor) -> torch.Tensor:
        """x_cf [3, B] in [-1, 1] -> sdf [1, B] f32."""
        h = self.encoder.cf(x_cf, bound=1.0)
        h = self.backbone.cf(h).float()
        if self.clip_sdf is not None:
            h = torch.clamp(h, -self.clip_sdf, self.clip_sdf)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., 3] in [-1, 1] -> sdf [..., 1]."""
        prefix = x.shape[:-1]
        return self.cf(x.reshape(-1, 3).T).T.reshape(*prefix, 1)
