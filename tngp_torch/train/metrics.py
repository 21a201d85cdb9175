"""Evaluation metrics — the port of `tngp/train/metrics.py`: `PSNRMeter`,
single-scale SSIM (scipy's `gaussian_filter`, sigma 1.5) with its
`SSIMMeter`, and the `LPIPSMeter` shim, which reports NaN where the `lpips`
package is missing and refuses to count where it is present, since it does
not compute LPIPS.  All work on host arrays."""

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


def ssim(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0) -> float:
    """Single-scale SSIM with a gaussian window (sigma 1.5) on HWC float
    images."""
    from scipy.ndimage import gaussian_filter

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    mu0 = gaussian_filter(img0, sigma=1.5, axes=(0, 1))
    mu1 = gaussian_filter(img1, sigma=1.5, axes=(0, 1))
    s00 = gaussian_filter(img0 * img0, sigma=1.5, axes=(0, 1)) - mu0**2
    s11 = gaussian_filter(img1 * img1, sigma=1.5, axes=(0, 1)) - mu1**2
    s01 = gaussian_filter(img0 * img1, sigma=1.5, axes=(0, 1)) - mu0 * mu1
    num = (2 * mu0 * mu1 + c1) * (2 * s01 + c2)
    den = (mu0**2 + mu1**2 + c1) * (s00 + s11 + c2)
    return float(np.mean(num / den))


class SSIMMeter:
    def __init__(self):
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        self.V += ssim(preds, truths)
        self.N += 1

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"SSIM = {self.measure():.6f}"


class LPIPSMeter:
    """Counts nothing and reports NaN.  Where the `lpips` package imports,
    `update` raises: a frame counted with no value added would report a
    perfect 0.0 that was never computed."""

    def __init__(self, net: str = "alex"):
        self.net = net
        self.available = False
        try:
            import lpips  # noqa: F401

            self.available = True
        except Exception:
            pass
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 0

    def update(self, preds, truths):
        if self.available:
            raise NotImplementedError("LPIPSMeter does not compute LPIPS; the port has no "
                                      "LPIPS network")

    def measure(self) -> float:
        return self.V / self.N if self.N else float("nan")

    def report(self) -> str:
        return f"LPIPS ({self.net}) = {self.measure():.6f}"
