"""PSNR and SSIM (counterparts of ``envidr_tpu/train/metrics.py``; LPIPS waits)."""

from __future__ import annotations

import numpy as np


def psnr(preds, truths) -> float:
    """-10 log10(MSE) in float64; MSE is floored at 1e-12."""
    preds = np.asarray(preds, np.float64)
    truths = np.asarray(truths, np.float64)
    return float(-10.0 * np.log10(max(np.mean((preds - truths) ** 2), 1e-12)))


class PSNRMeter:
    def __init__(self):
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def update(self, preds, truths) -> float:
        p = psnr(preds, truths)
        self.V += p
        self.N += 1
        return p

    def measure(self) -> float:
        return self.V / max(self.N, 1)


class SSIMMeter:
    """Gaussian-windowed SSIM (window 11, sigma 1.5, reflect padding), in
    numpy float64 (counterpart of ``envidr_tpu/train/metrics.py:SSIMMeter``)."""

    def __init__(self, sigma: float = 1.5, win: int = 11):
        r = np.arange(win) - win // 2
        k = np.exp(-(r**2) / (2 * sigma**2))
        self.kernel = (k / k.sum()).astype(np.float64)
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    def _blur(self, img):
        """Separable Gaussian over the two image axes, each channel alone."""
        from numpy.lib.stride_tricks import sliding_window_view
        pad = len(self.kernel) // 2
        out = img
        for axis in (0, 1):
            out = np.pad(out, [(pad, pad) if a == axis else (0, 0) for a in range(out.ndim)],
                         mode="reflect")
            win = sliding_window_view(out, len(self.kernel), axis=axis)
            out = np.tensordot(win, self.kernel, axes=([-1], [0]))
        return out

    def update(self, preds, truths) -> float:
        x = np.asarray(preds, np.float64)
        y = np.asarray(truths, np.float64)
        c1, c2 = 0.01**2, 0.03**2
        mx, my = self._blur(x), self._blur(y)
        sxx = self._blur(x * x) - mx * mx
        syy = self._blur(y * y) - my * my
        sxy = self._blur(x * y) - mx * my
        ssim = ((2 * mx * my + c1) * (2 * sxy + c2)
                / ((mx * mx + my * my + c1) * (sxx + syy + c2)))
        v = float(ssim.mean())
        self.V += v
        self.N += 1
        return v

    def measure(self) -> float:
        return self.V / max(self.N, 1)
