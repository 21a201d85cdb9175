"""Encoder modules and the `get_encoder` factory — the port of
`tngp/encoders/modules.py`: `hashgrid` / `tiledgrid` (the golden hash grid,
`GridEncoder`, with position gradients unless `input_grad=False`),
`hashgrid_window` (the windowed grid encoder, with position gradients on
request), the spherical-harmonics direction encoder, the frequency encoder
and the identity.  The Minkowski point-cloud encoders raise, as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
from torch import nn

from ..kernels.window_encoder import DEFAULT_BLOCK, window_encode_binned
from ..ops.freq import freq_encode_cf, freq_output_dim
from ..ops.hashgrid import HashGridSpec, hash_encode, hash_encode_cf_vjp
from ..ops.sh import sh_encode_cf
from ..ops.window_table import WindowSpec


class GridEncoder(nn.Module):
    """Multiresolution hash/tiled grid encoder.  The trainable parameter
    `embeddings` is the flat table [total_params, C] f32; `cf` is the
    channels-first path (`[D, B]` -> `[L*C, B]`) whose backward adds the
    table gradient through the `scatter_add_any` kernel on the card;
    calling the module is batch-first (`[..., D]` -> `[..., L*C]`)."""

    def __init__(self, spec: HashGridSpec, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.embeddings = nn.Parameter(spec.init_table(generator, device))

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def forward(self, x: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        # inputs in [-bound, bound] -> [0, 1] (grid.py:807)
        x01 = (x + bound) / (2.0 * bound)
        return hash_encode(x01, self.embeddings, self.spec)

    def cf(self, x_cf: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        x01 = (x_cf + bound) / (2.0 * bound)
        return hash_encode_cf_vjp(x01, self.embeddings, self.spec)


class WindowGridEncoder(nn.Module):
    """Multiresolution grid encoder over the windowed table layout.  The
    trainable parameter `embeddings` is the window layout [n_windows, C,
    128, 64]; `cf` runs the binned path (kernels on the card, plain versions
    on CPU), whose backward gives the table gradient and, with
    `input_grads=True` (an encoder whose input is itself a network output,
    as D-NeRF's canonical encode at x + dx), the positions' gradient.
    `mxu_f32=True` computes in true f32 (the f32 form of the kernels) where
    the default rounds corner operands to bf16, as the JAX module's option."""

    def __init__(self, spec: WindowSpec, block: int = DEFAULT_BLOCK, device="cuda",
                 generator: torch.Generator | None = None, input_grads: bool = False,
                 mxu_f32: bool = False):
        super().__init__()
        self.spec = spec
        self.block = block
        self.input_grads = input_grads
        self.mxu_f32 = mxu_f32
        self.embeddings = nn.Parameter(spec.init_table_win(generator, device))

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def cf(self, x_cf: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        """[3, B] in [-bound, bound] -> [L*C, B]."""
        x01 = (x_cf + bound) / (2.0 * bound)
        return window_encode_binned(x01, self.embeddings, self.spec, self.block,
                                    self.input_grads, self.mxu_f32)


class SHEncoder(nn.Module):
    def __init__(self, degree: int = 4):
        super().__init__()
        self.degree = degree

    @property
    def output_dim(self) -> int:
        return self.degree**2

    def cf(self, d_cf: torch.Tensor) -> torch.Tensor:
        return sh_encode_cf(d_cf, self.degree)


class IdentityEncoder(nn.Module):
    def __init__(self, input_dim: int = 3):
        super().__init__()
        self.input_dim = input_dim

    @property
    def output_dim(self) -> int:
        return self.input_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def cf(self, x_cf: torch.Tensor) -> torch.Tensor:
        return x_cf


class FreqEncoder(nn.Module):
    """Frequency encoding with `degree` octaves (bands 2^0 .. 2^(degree-1))."""

    def __init__(self, degree: int = 6, input_dim: int = 3):
        super().__init__()
        self.degree = degree
        self.input_dim = input_dim

    @property
    def output_dim(self) -> int:
        return freq_output_dim(self.input_dim, self.degree)

    def cf(self, x_cf: torch.Tensor) -> torch.Tensor:
        """[D, B] -> [D * (1 + 2 * degree), B]."""
        return freq_encode_cf(x_cf, self.degree)


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    multires: int = 6,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    align_corners: bool = False,
    interpolation: str = "linear",
    input_grad: bool = True,
    device="cuda",
    generator: torch.Generator | None = None,
    input_grads: bool = False,
    mxu_f32: bool = False,
) -> Tuple[nn.Module, int]:
    """Name -> (module, output_dim), as the JAX factory.  `input_grad`
    (default on) gives the golden grid's backward its position gradient;
    `input_grads` (default off) asks the window encoder for one.  The window
    encoder computes in true f32 with `mxu_f32=True` or with the environment
    variable `TNGP_MXU_F32=1` (`tngp/encoders/modules.py:200-206`; the
    models reach it through the variable).  `TNGP_WIN_SWAP` has no
    counterpart: it picks one of two TPU matmul orientations that give the
    same bits."""
    if encoding in (None, "None", "none"):
        return IdentityEncoder(input_dim=input_dim), input_dim
    if encoding == "frequency":
        enc = FreqEncoder(degree=multires, input_dim=input_dim)
        return enc, enc.output_dim
    if encoding in ("sphere_harmonics", "spherical_harmonics", "sh"):
        enc = SHEncoder(degree=degree)
        return enc, enc.output_dim
    if encoding == "hashgrid_window":
        if input_dim != 3:
            raise ValueError("hashgrid_window supports input_dim=3 only")
        spec = WindowSpec.create(
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            align_corners=align_corners,
            interpolation=interpolation,
        )
        enc = WindowGridEncoder(
            spec, device=device, generator=generator, input_grads=input_grads,
            mxu_f32=bool(mxu_f32) or os.environ.get("TNGP_MXU_F32", "0") == "1")
        return enc, spec.output_dim
    if encoding in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec.create(
            input_dim=input_dim,
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners,
            interpolation=interpolation,
            input_grad=input_grad,
        )
        return GridEncoder(spec, device=device, generator=generator), spec.output_dim
    if "minkowski" in str(encoding) or encoding in ("hashgrid_geo", "ash"):
        raise NotImplementedError(
            f"encoder '{encoding}' is a point-cloud encoder (MinkowskiEngine-based), "
            "which the JAX package does not build either")
    raise ValueError(f"unknown encoding: {encoding}")
