"""Volumetric compositing over fixed-length sample axes.

Counterpart of ``envidr_tpu/ops/compositing.py``: transmittance is an
exclusive cumulative product; invalid samples carry sigma = 0.
"""

from __future__ import annotations

import torch


def alphas_from_sigmas(sigmas: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """alpha_i = 1 - exp(-delta_i * sigma_i)."""
    return 1.0 - torch.exp(-deltas * sigmas)


class _CumprodNoZeros(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of a tensor without zeros.  Its
    backward is torch's own for that case, ``reversed_cumsum(out * grad) /
    x``, without torch's test for zeros, which reads a flag back to the host
    and so blocks it."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1) / x


def weights_from_alphas(alphas: torch.Tensor, T_thresh: float = 0.0) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j + 1e-15); with T_thresh > 0
    samples whose incoming transmittance fell below it get weight 0.  The
    factors are at least 1e-15 (alpha <= 1), never zero."""
    one_minus = 1.0 - alphas + 1e-15
    T = _CumprodNoZeros.apply(torch.cat([torch.ones_like(one_minus[..., :1]),
                                         one_minus[..., :-1]], dim=-1))
    w = alphas * T
    if T_thresh > 0.0:
        w = torch.where(T > T_thresh, w, torch.zeros_like(w))
    return w


def composite(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_i w_i * v_i -> [N, C]."""
    return (weights[..., None] * values).sum(dim=-2)


def composite_rays(sigmas, rgbs, deltas, z_vals, *, input_alpha: bool = False,
                   T_thresh: float = 0.0):
    """-> (weights_sum [N], depth [N], image [N, C], weights [N, S])."""
    alphas = sigmas if input_alpha else alphas_from_sigmas(sigmas, deltas)
    weights = weights_from_alphas(alphas, T_thresh=T_thresh)
    return (weights.sum(dim=-1), (weights * z_vals).sum(dim=-1),
            composite(weights, rgbs), weights)
