"""D-NeRF networks — the port of `tngp/models/dnerf.py`: `DNeRFNetwork`
(the deformation field, with the background model), `DNeRFBasisNetwork`
(`--basis`) and `DNeRFHyperNetwork` (`--hyper`).

DNeRFNetwork: freq(x, 10 octaves) ++ freq(t, 6 octaves) -> 5x128 bias-free
deform MLP -> dx; the canonical grid encode happens at x + dx (so the
encoder passes gradients back to positions, and through them to the deform
net); the sigma MLP sees [enc(x + dx), enc_t, enc_x] -> (sigma = trunc_exp,
15 geo features); SH(dir) ++ geo features -> 3x64 MLP -> sigmoid (no
padding, unlike NGP).

DNeRFBasisNetwork: a time MLP gives 32 sigma and 8 colour basis
coefficients; the spatial nets give per-basis features contracted with
them.  DNeRFHyperNetwork: a time MLP gives 2 ambient coordinates
(tanh * bound) appended to x before a 5-D grid encode, whose position
gradient trains the time MLP.  Neither returns a deform (None), and neither
has a background model, as in the JAX package.

The canonical encoder defaults to `tiledgrid` at the JAX width.  One time t
in [0, 1] per call, a host number: the time row is filled on the device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..encoders import get_encoder
from ..ops.activation import trunc_exp
from .common import MLP
from .ngp import _background_cf


def _time_row(t: float, n: int, device) -> torch.Tensor:
    """[1, n] filled with t on `device` (no upload)."""
    return torch.full((1, n), float(t), dtype=torch.float32, device=device)


class DNeRFNetwork(nn.Module):
    """Parameters are named as the flax module's (`deform_net.dense_i`,
    `encoder.embeddings`, `sigma_net.dense_i`, `color_net.dense_i`, and with
    the background `encoder_bg.embeddings`, `bg_net.dense_i`), so
    `convert.py` maps a flax param tree onto `state_dict` keys one to one.
    Initial weights are drawn from the JAX package's init distributions with
    `seed`.  `num_levels`, `level_dim`, `base_resolution` and
    `log2_hashmap_size` size the canonical encoder (the JAX module uses the
    factory's defaults, 16, 2, 16 and 19)."""

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
        num_layers_bg: int = 2,
        hidden_dim_bg: int = 64,
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
            input_grad=True, input_grads=True,
        )
        self.sigma_net = MLP(in_dim + in_dim_time + in_dim_deform, hidden_dim,
                             1 + geo_feat_dim, num_layers, compute_dtype, device, gen)
        self.encoder_dir, in_dim_dir = get_encoder(encoding_dir)
        self.color_net = MLP(in_dim_dir + geo_feat_dim, hidden_dim_color, 3,
                             num_layers_color, compute_dtype, device, gen)
        if bg_radius > 0:
            self.encoder_bg, in_dim_bg = get_encoder(
                "hashgrid", input_dim=2, num_levels=4, log2_hashmap_size=19,
                desired_resolution=2048, device=device, generator=gen,
            )
            self.bg_net = MLP(in_dim_dir + in_dim_bg, hidden_dim_bg, 3, num_layers_bg,
                              compute_dtype, device, gen)

    def _deform_cf(self, x_cf: torch.Tensor, t: float):
        """Returns (enc_ori_x [63, B], enc_t [13, B], deform [3, B])."""
        enc_ori = self.encoder_deform.cf(x_cf.float())
        enc_t = self.encoder_time.cf(_time_row(t, x_cf.shape[1], x_cf.device))
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

    def background_cf(self, sph_cf: torch.Tensor, d_cf: torch.Tensor) -> torch.Tensor:
        """sph_cf [2, B] sphere coordinates in [-1, 1], d_cf [3, B] -> rgb [3, B]."""
        return _background_cf(self, sph_cf, d_cf)


class DNeRFBasisNetwork(nn.Module):
    """The temporal-basis variant (`--basis`): `basis_net.dense_i`,
    `encoder.embeddings`, `sigma_net.dense_i`, `color_net.dense_i`.
    The encoder size arguments are as `DNeRFNetwork`'s."""

    def __init__(
        self,
        bound: float = 1.0,
        encoding: str = "tiledgrid",
        multires_time: int = 6,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 32,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        sigma_basis_dim: int = 32,
        color_basis_dim: int = 8,
        num_layers_basis: int = 5,
        hidden_dim_basis: int = 128,
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
        gen = torch.Generator().manual_seed(seed)
        self.bound = bound
        self.bg_radius = bg_radius
        self.sigma_basis_dim = sigma_basis_dim
        self.color_basis_dim = color_basis_dim
        self.encoder_time, in_dim_time = get_encoder("frequency", input_dim=1,
                                                     multires=multires_time)
        self.basis_net = MLP(in_dim_time, hidden_dim_basis, sigma_basis_dim + color_basis_dim,
                             num_layers_basis, compute_dtype, device, gen)
        self.encoder, in_dim = get_encoder(
            encoding, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=int(2048 * bound), device=device, generator=gen,
        )
        self.sigma_net = MLP(in_dim, hidden_dim, sigma_basis_dim + geo_feat_dim, num_layers,
                             compute_dtype, device, gen)
        self.encoder_dir, in_dim_dir = get_encoder("sphere_harmonics")
        self.color_net = MLP(in_dim_dir + geo_feat_dim, hidden_dim_color,
                             3 * color_basis_dim, num_layers_color, compute_dtype, device, gen)

    def _basis(self, t: float, device):
        enc_t = self.encoder_time.cf(_time_row(t, 1, device))  # [13, 1]
        h = self.basis_net.cf(enc_t)[:, 0].float()
        return h[:self.sigma_basis_dim], h[self.sigma_basis_dim:]

    def _sigma(self, x_cf: torch.Tensor, sigma_basis: torch.Tensor):
        h = self.sigma_net.cf(self.encoder.cf(x_cf, bound=self.bound)).float()  # [SB+G, B]
        sigma = trunc_exp(torch.matmul(sigma_basis, h[:self.sigma_basis_dim]))
        return sigma, h[self.sigma_basis_dim:]

    def density_cf(self, x_cf: torch.Tensor, t: float):
        sigma_basis, _ = self._basis(t, x_cf.device)
        sigma, geo = self._sigma(x_cf, sigma_basis)
        return {"sigma": sigma, "geo_feat": geo}

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor, t: float):
        """-> (sigma [B], rgb [3, B], None)."""
        sigma_basis, color_basis = self._basis(t, x_cf.device)
        sigma, geo = self._sigma(x_cf, sigma_basis)
        hc = torch.cat([self.encoder_dir.cf(d_cf).to(geo.dtype), geo], dim=0)
        hc = self.color_net.cf(hc).float().reshape(3, self.color_basis_dim, -1)  # [3, CB, B]
        rgb = torch.sigmoid(torch.einsum("c,kcb->kb", color_basis, hc))
        return sigma, rgb, None


class DNeRFHyperNetwork(nn.Module):
    """The ambient-dimension variant (`--hyper`): `ambient_net.dense_i`,
    `encoder.embeddings` (a (3 + ambient_dim)-D grid), `sigma_net.dense_i`,
    `color_net.dense_i`.  The encoder size arguments are as
    `DNeRFNetwork`'s."""

    def __init__(
        self,
        bound: float = 1.0,
        encoding: str = "tiledgrid",
        ambient_dim: int = 2,
        multires_time: int = 6,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        num_layers_ambient: int = 3,
        hidden_dim_ambient: int = 64,
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
        gen = torch.Generator().manual_seed(seed)
        self.bound = bound
        self.bg_radius = bg_radius
        self.ambient_dim = ambient_dim
        self.encoder_time, in_dim_time = get_encoder("frequency", input_dim=1,
                                                     multires=multires_time)
        self.ambient_net = MLP(in_dim_time, hidden_dim_ambient, ambient_dim,
                               num_layers_ambient, compute_dtype, device, gen)
        # the ambient coordinates are a network output: the encoder's
        # position gradient trains the ambient net
        self.encoder, in_dim = get_encoder(
            encoding, input_dim=3 + ambient_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=int(2048 * bound), device=device, generator=gen,
        )
        self.sigma_net = MLP(in_dim, hidden_dim, 1 + geo_feat_dim, num_layers, compute_dtype,
                             device, gen)
        self.encoder_dir, in_dim_dir = get_encoder("sphere_harmonics")
        self.color_net = MLP(in_dim_dir + geo_feat_dim, hidden_dim_color, 3, num_layers_color,
                             compute_dtype, device, gen)

    def _ambient(self, t: float, device) -> torch.Tensor:
        enc_t = self.encoder_time.cf(_time_row(t, 1, device))  # [13, 1]
        amb = self.ambient_net.cf(enc_t).float()  # [A, 1]
        return torch.tanh(amb) * self.bound

    def density_cf(self, x_cf: torch.Tensor, t: float):
        amb = self._ambient(t, x_cf.device)
        xa = torch.cat([x_cf, amb.expand(self.ambient_dim, x_cf.shape[1])], dim=0)
        h = self.sigma_net.cf(self.encoder.cf(xa, bound=self.bound))
        return {"sigma": trunc_exp(h[0].float()), "geo_feat": h[1:]}

    def sigma_rgb_cf(self, x_cf: torch.Tensor, d_cf: torch.Tensor, t: float):
        """-> (sigma [B], rgb [3, B], None)."""
        out = self.density_cf(x_cf, t)
        geo = out["geo_feat"]
        h = torch.cat([self.encoder_dir.cf(d_cf).to(geo.dtype), geo], dim=0)
        rgb = torch.sigmoid(self.color_net.cf(h).float())
        return out["sigma"], rgb, None
