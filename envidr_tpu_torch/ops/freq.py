"""Classic NeRF frequency encoding (counterpart of ``envidr_tpu/ops/freq.py``):
``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{D-1} x), cos(2^{D-1} x)]``."""

from __future__ import annotations

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    if degree <= 0:
        return input_dim
    return input_dim + input_dim * 2 * degree


def freq_encode(x: torch.Tensor, *, degree: int) -> torch.Tensor:
    """Positional encoding; identity when degree == 0."""
    if degree <= 0:
        return x
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                     # [..., D, C]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., D, 2, C]
    enc = enc.reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1)
