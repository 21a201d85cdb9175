"""Real spherical-harmonics direction encoding (degrees 1..8) — the port of
`tngp/ops/sh.py`.  The polynomials are generated from the same recurrences,
in Cartesian form (graphics convention, Condon-Shortley phase folded into
P_l^m, component index l^2 + l + m):

  C_m + i S_m = (x + i y)^m
  Pb_m^m      = (-1)^m (2m-1)!!
  Pb_{m+1}^m  = (2m+1) z Pb_m^m
  Pb_l^m      = ((2l-1) z Pb_{l-1}^m - (l+m-1) Pb_{l-2}^m) / (l - m)
  y_{l,+-m}   = sqrt(2) K_l^m {C_m | S_m} Pb_l^m,   y_{l,0} = K_l^0 Pb_l^0
"""

from __future__ import annotations

import math

import torch


def _K(l: int, m: int) -> float:
    return math.sqrt(
        (2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m)
    )


def sh_encode_cf(d_cf: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Channels-first encode: [3, B] unit directions -> [degree**2, B]."""
    if not (1 <= degree <= 8):
        raise ValueError(f"degree must be in [1, 8], got {degree}")
    xf, yf, zf = (d_cf[i].float() for i in range(3))

    C = [torch.ones_like(xf)]
    S = [torch.zeros_like(xf)]
    for m in range(1, degree):
        C.append(xf * C[m - 1] - yf * S[m - 1])
        S.append(xf * S[m - 1] + yf * C[m - 1])

    Pb: dict[tuple[int, int], torch.Tensor] = {}
    for m in range(degree):
        pmm = ((-1.0) ** m) * math.prod(range(1, 2 * m, 2)) if m > 0 else 1.0
        Pb[(m, m)] = torch.full_like(zf, float(pmm))
        if m + 1 < degree:
            Pb[(m + 1, m)] = (2 * m + 1) * zf * Pb[(m, m)]
        for l in range(m + 2, degree):
            Pb[(l, m)] = (
                (2 * l - 1) * zf * Pb[(l - 1, m)] - (l + m - 1) * Pb[(l - 2, m)]
            ) / (l - m)

    out: list[torch.Tensor | None] = [None] * (degree * degree)
    sqrt2 = math.sqrt(2.0)
    for l in range(degree):
        out[l * l + l] = _K(l, 0) * Pb[(l, 0)]
        for m in range(1, l + 1):
            k = sqrt2 * _K(l, m)
            out[l * l + l + m] = k * C[m] * Pb[(l, m)]
            out[l * l + l - m] = k * S[m] * Pb[(l, m)]
    return torch.stack(out, dim=0).to(d_cf.dtype)
