"""Encoder modules and the `get_encoder` factory — the port of the names of
`tngp/encoders/modules.py` that the NGP paths use: `hashgrid_window`
(the windowed grid encoder) and the spherical-harmonics direction encoder.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..kernels.window_encoder import DEFAULT_BLOCK, window_encode_binned
from ..ops.sh import sh_encode_cf
from ..ops.window_table import WindowSpec


class WindowGridEncoder(nn.Module):
    """Multiresolution grid encoder over the windowed table layout.  The
    trainable parameter `embeddings` is the window layout [n_windows, C,
    128, 64]; `cf` runs the binned path (kernels on the card, plain versions
    on CPU), whose backward gives the table gradient and none for positions."""

    def __init__(self, spec: WindowSpec, block: int = DEFAULT_BLOCK, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.block = block
        self.embeddings = nn.Parameter(spec.init_table_win(generator, device))

    @property
    def output_dim(self) -> int:
        return self.spec.output_dim

    def cf(self, x_cf: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        """[3, B] in [-bound, bound] -> [L*C, B]."""
        x01 = (x_cf + bound) / (2.0 * bound)
        return window_encode_binned(x01, self.embeddings, self.spec, self.block)


class SHEncoder(nn.Module):
    def __init__(self, degree: int = 4):
        super().__init__()
        self.degree = degree

    @property
    def output_dim(self) -> int:
        return self.degree**2

    def cf(self, d_cf: torch.Tensor) -> torch.Tensor:
        return sh_encode_cf(d_cf, self.degree)


def get_encoder(
    encoding: str,
    input_dim: int = 3,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int = 2048,
    align_corners: bool = False,
    interpolation: str = "linear",
    device="cuda",
    generator: torch.Generator | None = None,
) -> Tuple[nn.Module, int]:
    """Name -> (module, output_dim) for the encoders this port has."""
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
        enc = WindowGridEncoder(spec, device=device, generator=generator)
        return enc, spec.output_dim
    raise NotImplementedError(f"encoder '{encoding}' is not ported yet")
