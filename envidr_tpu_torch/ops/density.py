"""SDF -> density transforms and the truncated-exp activation.

Counterpart of ``envidr_tpu/ops/density.py`` (Laplace density and
``trunc_exp``; the NeuS alpha waits for the slice that needs it).
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    """exp whose gradient uses exp of the input clamped to [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def laplace_beta(beta: torch.Tensor, beta_min: float = 0.0001,
                 beta_max: float = 1.0) -> torch.Tensor:
    """Clamped beta with a straight-through gradient."""
    b = beta.detach()
    return beta + (b.clamp(beta_min, beta_max) - b)


def laplace_density(sdf, beta, alpha=None):
    """alpha * Laplace(0, beta).cdf(-sdf); alpha defaults to 1/beta."""
    if alpha is None:
        alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta))
