"""D-NeRF deformation-field network — the port of `tngp/models/dnerf.py`
`DNeRFNetwork` without the background model.

deform net: freq(x, 10 octaves) ++ freq(t, 6 octaves) -> 5x128 bias-free MLP
-> dx; the canonical grid encode happens at x + dx (so the encoder passes
gradients back to positions, and through them to the deform net); the
sigma MLP sees [enc(x + dx), enc_t, enc_x] -> (sigma = trunc_exp, 15 geo
features); SH(dir) ++ geo features -> 3x64 MLP -> sigmoid (no padding, unlike
NGP).  One time t in [0, 1] per call.

The basis and hyper variants, and the default `encoding="tiledgrid"`, wait for
the golden hash grid (ROADMAP item 11); only `hashgrid_window` is ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..encoders import get_encoder
from ..ops.activation import trunc_exp
from .common import MLP


class DNeRFNetwork(nn.Module):
    """Parameters are named as the flax module's (`deform_net.dense_i`,
    `encoder.embeddings`, `sigma_net.dense_i`, `color_net.dense_i`), so
    `convert.py` maps a flax param tree onto `state_dict` keys one to one.
    Initial weights are drawn from the JAX package's init distributions with
    `seed`.  `num_levels`, `level_dim`, `base_resolution` and
    `log2_hashmap_size` size the encoder (the JAX module uses its defaults,
    16, 2, 16 and 19)."""

    def __init__(
        self,
        bound: float = 1.0,
        encoding: str = "tiledgrid",
        encoding_dir: str = "sphere_harmonics",
        multires_deform: int = 10,
        multires_time: int = 6,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        num_layers_deform: int = 5,
        hidden_dim_deform: int = 128,
        bg_radius: float = -1.0,
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        log2_hashmap_size: int = 19,
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
        self.encoder_deform, in_dim_deform = get_encoder("frequency", multires=multires_deform)
        self.encoder_time, in_dim_time = get_encoder("frequency", input_dim=1,
                                                     multires=multires_time)
        self.deform_net = MLP(in_dim_deform + in_dim_time, hidden_dim_deform, 3,
                              num_layers_deform, compute_dtype, device, gen)
        # the canonical encode happens at x + dx: gradients flow back through
        # positions into the deform net
        self.encoder, in_dim = get_encoder(
            encoding, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=int(2048 * bound), device=device, generator=gen,
            input_grads=True,
        )
        self.sigma_net = MLP(in_dim + in_dim_time + in_dim_deform, hidden_dim,
                             1 + geo_feat_dim, num_layers, compute_dtype, device, gen)
        self.encoder_dir, in_dim_dir = get_encoder(encoding_dir)
        self.color_net = MLP(in_dim_dir + geo_feat_dim, hidden_dim_color, 3,
                             num_layers_color, compute_dtype, device, gen)

    def _deform_cf(self, x_cf: torch.Tensor, t: float):
        """Returns (enc_ori_x [63, B], enc_t [13, B], deform [3, B]).  `t` is
        a host number: the time row is filled on the device, no upload."""
        B = x_cf.shape[1]
        enc_ori = self.encoder_deform.cf(x_cf.float())
        t_row = torch.full((1, B), float(t), dtype=torch.float32, device=x_cf.device)
        enc_t = self.encoder_time.cf(t_row)
        deform = self.deform_net.cf(torch.cat([enc_ori, enc_t], dim=0)).float()
        return enc_ori, enc_t, deform

    def density_cf(self, x_cf: torch.Tensor, t: float):
        """x_cf [3, B] in [-bound, bound] at time t -> {'sigma': [B],
        'geo_feat': [15, B], 'deform': [3, B]}."""
        enc_ori, enc_t, deform = self._deform_cf(x_cf, t)
        h = self.encoder.cf(x_cf + deform, bound=self.bound)  # [L*C, B]
        h = torch.cat([h, enc_t.to(h.dtype), enc_ori.to(h.dtype)], dim=0)
        h = self.sigma_net.cf(h)
        return {"sigma": trunc_exp(h[0].float()), "geo_feat": h[1:], "deform": deform}

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor, t: float):
        """-> (sigma [B], rgb [3, B], deform [3, B])."""
        out = self.density_cf(x_cf, t)
        geo = out["geo_feat"]
        h = torch.cat([self.encoder_dir.cf(d_cf).to(geo.dtype), geo], dim=0)
        rgb = torch.sigmoid(self.color_net.cf(h).float())
        return out["sigma"], rgb, out["deform"]
