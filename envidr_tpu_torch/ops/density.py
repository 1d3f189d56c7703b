"""SDF -> density transforms and the truncated-exp activation.

Counterpart of ``envidr_tpu/ops/density.py``: the Laplace density, the NeuS
section-CDF alpha and ``trunc_exp``.
"""

from __future__ import annotations

import torch

SQRT3 = 3.0**0.5


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


def init_laplace_params(init_beta: float = 0.1):
    return {"beta": torch.tensor(float(init_beta))}


def init_neus_params(init_variance: float = 0.3):
    return {"variance": torch.tensor(float(init_variance))}


def neus_alpha(sdf, variance, dirs=None, dists=None, gradients=None,
               cos_anneal_ratio=1.0, n_detach: bool = False):
    """NeuS section-CDF alpha in [0, 1] (not a sigma: the renderer composites
    it as an alpha).  sdf [...]; dirs, gradients [..., 3] or None; dists
    [...] or a number; ``cos_anneal_ratio`` a number or a tensor."""
    inv_s = torch.clamp(torch.exp(variance * 10.0), 1e-6, 1e6)
    if gradients is not None:
        g = gradients.detach() if n_detach else gradients
        true_cos = (dirs * g).sum(dim=-1)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)   # never positive
        est_next = sdf + iter_cos * dists * 0.5
        est_prev = sdf - iter_cos * dists * 0.5
    else:
        est_next = sdf - dists * 0.5
        est_prev = sdf + dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    p = prev_cdf - next_cdf
    c = prev_cdf
    return torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)
