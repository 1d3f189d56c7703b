"""PSNR, SSIM and LPIPS meters (counterparts of ``envidr_tpu/train/metrics.py``)."""

from __future__ import annotations

import os

import numpy as np
import torch

from envidr_tpu_torch import resolve_device

DEFAULT_LPIPS_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "lpips_alex.pth")


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


class LPIPSMeter:
    """AlexNet LPIPS (``utils.py:314-348``), resolved in the JAX package's
    order: (1) the ``lpips`` package, where it imports and builds (kind
    ``net``); (2) the port's :class:`~envidr_tpu_torch.train.lpips.LPIPS`
    with the weights of ``$ENVIDR_LPIPS_WEIGHTS`` or ``assets/lpips_alex.pth``
    (kind ``alex``); (3) the same with the deterministic untrained trunk
    (kind ``alex_untrained``).  It runs on ``device`` (the card unless
    ``cpu``)."""

    def __init__(self, net: str = "alex", device=None):
        self.device = resolve_device(device)
        self.fn = None
        try:
            import lpips
            self.fn = lpips.LPIPS(net=net).to(self.device)
            self.kind = net
        except (ImportError, OSError):     # no package, or no weights to fetch
            from envidr_tpu_torch.train.lpips import LPIPS
            wpath = os.environ.get("ENVIDR_LPIPS_WEIGHTS", "")
            if not wpath and os.path.exists(DEFAULT_LPIPS_WEIGHTS):
                wpath = DEFAULT_LPIPS_WEIGHTS
            self._lpips = LPIPS(weights_path=wpath or None, device=self.device)
            self.kind = self._lpips.kind
        self.clear()

    def clear(self):
        self.V, self.N = 0.0, 0

    @property
    def available(self) -> bool:
        return True

    def update(self, preds, truths) -> float:
        """LPIPS of one [H, W, 3] pair in [0, 1]."""
        if self.fn is not None:
            def nchw(im):
                t = torch.as_tensor(np.asarray(im, np.float32), device=self.device)
                return t.permute(2, 0, 1)[None] * 2 - 1
            with torch.no_grad():
                v = float(self.fn(nchw(preds), nchw(truths)))
        else:
            v = self._lpips(preds, truths)
        self.V += v
        self.N += 1
        return v

    def measure(self) -> float:
        return self.V / max(self.N, 1)
