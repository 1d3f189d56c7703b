"""PSNR (counterpart of ``envidr_tpu/train/metrics.py:PSNRMeter``)."""

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
