"""LPIPS (AlexNet), the reference's second quality metric.

Counterpart of ``envidr_tpu/train/lpips.py``: the scaling layer, the
AlexNet trunk (five convolutions, a 3x3 stride-2 max-pool before the second
and the third), unit normalisation over channels, squared differences
weighted by the non-negative linear heads, averaged over space and summed
over the five stages.  The trunk is a library convolution (``F.conv2d``), as
the JAX package's is ``lax.conv_general_dilated``.

Weights: :func:`load_torch_weights` reads torchvision's AlexNet
(``features.{0,3,6,8,10}``) and the lpips package's heads
(``lin{i}.model.1.weight``); :func:`init_random_weights` draws the JAX
package's deterministic untrained trunk (kaiming normal, zero bias, uniform
``1/C`` heads) with numpy's generator in the same order, so that both
packages hold the same numbers.  Results of the untrained trunk are
labelled ``alex_untrained``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from envidr_tpu_torch import resolve_device

# (out_ch, in_ch, kernel, stride, pad, maxpool_before)
_ALEX = [
    (64, 3, 11, 4, 2, False),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, True),
    (256, 384, 3, 1, 1, False),
    (256, 256, 3, 1, 1, False),
]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_TORCHVISION_CONVS = (0, 3, 6, 8, 10)        # alexnet.features layer indices


def init_random_weights(seed: int = 0) -> Dict:
    """Deterministic kaiming-normal trunk, zero biases, uniform (1/C) heads:
    ``{"conv{i}": {"w", "b"}, "lin{i}": {"w"}}`` of numpy."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (co, ci, k, _, _, _) in enumerate(_ALEX):
        std = float(np.sqrt(2.0 / (ci * k * k)))
        params[f"conv{i}"] = {"w": rng.normal(0.0, std, (co, ci, k, k)).astype(np.float32),
                              "b": np.zeros((co,), np.float32)}
        params[f"lin{i}"] = {"w": np.full((co,), 1.0 / co, np.float32)}
    return params


def load_torch_weights(trunk_path: str, lin_path: Optional[str] = None) -> Dict:
    """torchvision's AlexNet (``features.N.*``) and the lpips heads
    (``linN.model.1.weight``), from one file or two; a missing head is
    uniform."""
    from envidr_tpu_torch.io.torch_import import load_state_dict

    sd = dict(load_state_dict(trunk_path))
    if lin_path:
        sd.update(load_state_dict(lin_path))
    params = {}
    for i, li in enumerate(_TORCHVISION_CONVS):
        co = _ALEX[i][0]
        params[f"conv{i}"] = {"w": np.asarray(sd[f"features.{li}.weight"], np.float32),
                              "b": np.asarray(sd[f"features.{li}.bias"], np.float32)}
        lk = f"lin{i}.model.1.weight"
        params[f"lin{i}"] = {"w": (np.asarray(sd[lk], np.float32).reshape(co) if lk in sd
                                   else np.full((co,), 1.0 / co, np.float32))}
    return params


class LPIPS(nn.Module):
    """LPIPS distance of [H, W, 3] images in [0, 1] (numpy or tensors).

    The weights of ``weights_path`` (and ``lin_path``) when that file
    exists, kind ``alex``; otherwise the untrained trunk of ``seed``, kind
    ``alex_untrained``.  The weights are buffers on ``device`` (the card
    unless ``cpu``, as ``resolve_device`` reads it)."""

    def __init__(self, weights_path: Optional[str] = None, lin_path: Optional[str] = None,
                 seed: int = 0, device=None):
        super().__init__()
        if weights_path and os.path.exists(weights_path):
            params, self.kind = load_torch_weights(weights_path, lin_path), "alex"
        else:
            params, self.kind = init_random_weights(seed), "alex_untrained"
        for i in range(len(_ALEX)):
            self.register_buffer(f"conv{i}_w", torch.from_numpy(params[f"conv{i}"]["w"]))
            self.register_buffer(f"conv{i}_b", torch.from_numpy(params[f"conv{i}"]["b"]))
            self.register_buffer(f"lin{i}_w", torch.from_numpy(params[f"lin{i}"]["w"]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[None, :, None, None])
        self.to(resolve_device(device))

    def features(self, x: torch.Tensor):
        """x [N, 3, H, W] in [-1, 1] -> the five stages' features.  Below
        31 pixels a side a pooling window no longer fits: that stage and the
        later ones are empty, and the distance NaN, as in the JAX package
        (its VALID ``reduce_window`` gives an empty array)."""
        h = (x - self.shift) / self.scale
        feats = []
        for i, (co, _, _, stride, pad, pool) in enumerate(_ALEX):
            if pool and h.numel():
                h = F.max_pool2d(h, 3, 2) if min(h.shape[-2:]) >= 3 else h[..., :0, :0]
            if h.numel():
                h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"),
                                    getattr(self, f"conv{i}_b"), stride=stride, padding=pad))
            else:
                h = h.new_zeros((h.shape[0], co, 0, 0))
            feats.append(h)
        return feats

    def distance(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] pairs in [-1, 1] -> [N]."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x0), self.features(x1))):
            a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-10)
            b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(1e-10)
            w = getattr(self, f"lin{i}_w").abs()[None, :, None, None]
            total = total + (w * (a - b) ** 2).sum(dim=1).mean(dim=(1, 2))
        return total

    @torch.no_grad()
    def forward(self, img0, img1) -> float:
        def to_nchw(im):
            t = torch.as_tensor(im, dtype=torch.float32, device=self.scale.device)
            return t.permute(2, 0, 1)[None] * 2.0 - 1.0

        return float(self.distance(to_nchw(img0), to_nchw(img1))[0])
