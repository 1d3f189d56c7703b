"""Integrated Directional Encoding (IDE), Ref-NeRF eqs. 6-8.

Counterpart of ``envidr_tpu/ops/ide.py``.  ``(x+iy)^m`` is built by the
polynomial complex-multiplication recurrence, never the ``r^m e^{i m
atan2(y, x)}`` form: that form has singular gradients as a direction
approaches +-z and NaN'd a training run of the reference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from envidr_tpu_torch import device_constant


def _generalized_binomial_coeff(a: float, k: int) -> float:
    return float(np.prod(a - np.arange(k)) / math.factorial(k))


def _assoc_legendre_coeff(l: int, m: int, k: int) -> float:
    # coefficient of cos^k(theta) * sin^m(theta) in P_l^m(cos theta)
    return ((-1) ** m * 2**l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    return (math.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                      / (4.0 * math.pi * math.factorial(l + m)))
            * _assoc_legendre_coeff(l, m, k))


@functools.lru_cache(maxsize=None)
def _ide_tables(deg_view: int):
    """(ml_array[2,P], mat[l_max+1,P], sigma[P]) as numpy constants."""
    ml_list = [(m, 2**i) for i in range(deg_view) for m in range(2**i + 1)]
    ml_array = np.array(ml_list, dtype=np.int64).T  # rows: (m, l)
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]), dtype=np.float64)
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(l, m, k)
    sigma = 0.5 * ml_array[1, :] * (ml_array[1, :] + 1)  # l(l+1)/2 roll-off
    return ml_array, mat, sigma.astype(np.float64)


def ide_output_dim(deg_view: int) -> int:
    return (2**deg_view - 1 + deg_view) * 2


def ide_encode(xyz: torch.Tensor, roughness=0.0, *, deg_view: int = 4) -> torch.Tensor:
    """[..., 3] directions (+ kappa^-1 roughness, scalar or [..., 1]) ->
    [..., (2^deg_view - 1 + deg_view) * 2] (real parts ++ imaginary parts)."""
    if deg_view > 5:
        raise ValueError("Only deg_view <= 5 is numerically stable.")
    ml_array, mat, sigma = _ide_tables(deg_view)
    dt, dev = xyz.dtype, xyz.device
    mat_t = device_constant(mat, dt, dev)                       # [l_max+1, P]
    sigma_t = device_constant(sigma, dt, dev)                   # [P]
    l_max = mat.shape[0] - 1

    x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
    # parity quirk of the reference: at exactly x=y=0 it nudges y to 1
    # (ide_encoder.py:114-115), so the +-z outputs are i^m instead of 0
    y = y + ((x == 0) & (y == 0)).to(dt)

    z_pows = [torch.ones_like(z)]
    for _ in range(l_max):
        z_pows.append(z_pows[-1] * z)
    z_component = torch.cat(z_pows, dim=-1) @ mat_t             # [..., P]

    m_max = int(ml_array[0].max())
    re_pows = [torch.ones_like(x)]
    im_pows = [torch.zeros_like(x)]
    for _ in range(m_max):
        re_pows.append(re_pows[-1] * x - im_pows[-1] * y)
        im_pows.append(re_pows[-2] * y + im_pows[-1] * x)
    m_idx = device_constant(ml_array[0], torch.long, dev)
    vmxy_re = torch.cat(re_pows, dim=-1).index_select(-1, m_idx)  # [..., P]
    vmxy_im = torch.cat(im_pows, dim=-1).index_select(-1, m_idx)

    kappa_inv = (torch.as_tensor(roughness, dtype=dt, device=dev)
                 if isinstance(roughness, torch.Tensor) else device_constant(roughness, dt, dev))
    scaled_z = z_component * torch.exp(-sigma_t * kappa_inv)
    return torch.cat([vmxy_re * scaled_z, vmxy_im * scaled_z], dim=-1)
