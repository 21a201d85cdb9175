"""Evaluation metrics — the port of `tngp/train/metrics.py` `PSNRMeter`."""

from __future__ import annotations

import numpy as np


class PSNRMeter:
    """Mean over updates of -10 log10(mse) on host arrays."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        preds, truths = np.asarray(preds), np.asarray(truths)
        mse = np.mean((preds - truths) ** 2)
        self.V += -10.0 * np.log10(max(mse, 1e-12))
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"PSNR = {self.measure():.6f}"
