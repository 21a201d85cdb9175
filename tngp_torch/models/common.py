"""Shared network blocks — the port of `tngp/models/common.py` `MLP`.

Activations are channels-first `[F, B]`, as in the JAX package.  Kernels are
stored `[fan_in, fan_out]` (the flax layout) so converted weights load as
they are.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def torch_linear_init(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the JAX package's init
    distribution (torch nn.Linear's default); shape = (fan_in, fan_out)."""
    bound = 1.0 / math.sqrt(shape[0])
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device="cpu")
    return ((u * 2.0 - 1.0) * bound).to(device)


class MLP(nn.Module):
    """Bias-free ReLU MLP.  With compute_dtype=bfloat16 every layer's
    product is taken in bf16 and its output rounded to bf16, as the JAX
    package's bf16 MXU chain; parameters stay f32."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 compute_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        self.output_dim = output_dim
        self.compute_dtype = compute_dtype
        d = in_dim
        for i in range(num_layers):
            out = output_dim if i == num_layers - 1 else hidden_dim
            self.register_parameter(
                f"dense_{i}", nn.Parameter(torch_linear_init((d, out), generator, device))
            )
            d = out

    def cf(self, x_cf: torch.Tensor) -> torch.Tensor:
        """[F, B] -> [output_dim, B]."""
        h = x_cf.to(self.compute_dtype)
        for i in range(self.num_layers):
            k = getattr(self, f"dense_{i}").to(self.compute_dtype)
            h = torch.matmul(k.T, h)
            if i != self.num_layers - 1:
                h = torch.relu(h)
        return h
