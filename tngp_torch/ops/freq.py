"""NeRF positional (frequency) encoding — the port of `tngp/ops/freq.py`
`freq_encode` and of `tngp/models/dnerf.py` `_freq_cf`, channels first: the
layout is `[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`, each
block the D input dimensions, for `degree` octaves; output_dim =
D * (1 + 2 * degree)."""

from __future__ import annotations

import torch


def freq_encode_cf(x_cf: torch.Tensor, degree: int) -> torch.Tensor:
    """Channels-first `[D, B]` -> `[D * (1 + 2 * degree), B]`."""
    outs = [x_cf]
    for i in range(degree):
        xi = x_cf * (2.0**i)
        outs.append(torch.sin(xi))
        outs.append(torch.cos(xi))
    return torch.cat(outs, dim=0)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)
