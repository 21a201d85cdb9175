"""Colour space conversions — the port of `tngp/utils/colors.py`, written
with plain operators so that they work on numpy arrays and torch tensors
alike."""

from __future__ import annotations


def srgb_to_linear(x):
    lo = x <= 0.04045
    return (x / 12.92) * lo + (((x + 0.055) / 1.055) ** 2.4) * (1 - lo)


def linear_to_srgb(x):
    eps = 1e-8
    lo = x <= 0.0031308
    hi = 1 - lo
    safe = x * hi + eps * lo  # no power of negatives or zero on the unused branch
    return (12.92 * x) * lo + (1.055 * safe ** (1 / 2.4) - 0.055) * hi
