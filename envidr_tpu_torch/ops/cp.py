"""CP-factorised multiresolution encoder.

Counterpart of ``envidr_tpu/ops/cp.py``.  Per level l and axis a the
features live in a 1-D table ``[R_l, rank]``; a point's feature on an axis is
the linear interpolation of two neighbouring rows, the three axis features
multiply (CP), and a per-level ``[rank, C]`` projection maps the product to
the ``[L*C]`` layout of the hash encoder.

The JAX package writes the interpolation as a dense two-hot matmul
(``formulation='twohot'``); at the train step's 262,144 points and R_l up to
2048 that matrix would hold 537M entries, so this port computes the same
numbers as a gather-lerp: only two columns of a two-hot row are non-zero.

``compute_dtype='bfloat16'`` (the default, as in the JAX package) rounds
what the JAX two-hot matmul rounds, in the forward and in every transpose
autodiff takes of it (``jax.make_jaxpr`` of its gradient shows the casts):

  * the weights: ``w1 = bf16(frac)``, ``w0 = bf16(1 - w1)`` (subtracted in
    bf16); the table rows are read as ``bf16(T)``; the two products are exact
    in f32 and summed in f32;
  * the table gradient is summed in f32 and rounded to bf16;
  * the gradient of each weight, ``g . bf16(T)``, is rounded to bf16, and the
    weights' two contributions to ``d frac`` are added in bf16.

Here each rounding is a ``.to(torch.bfloat16)`` in the autograd graph, so
autograd's backward (and its double backward, for the eikonal term) rounds
in the same places.  ``compute_dtype='float32'`` (either formulation) is the
plain f32 gather-lerp.

The two table rows of a point are read by ``ops/cp_rows.py``'s autograd
pair (on the card two CUDA kernels, a gather and its adjoint scatter; on the
CPU ``index_select`` and ``index_add_``), which is differentiable to any
order; every other op has a double backward in torch (products, casts,
``torch.where``), so the encoder is twice differentiable.  ``floor`` carries
no gradient and ``frac = pos - i0`` carries d/dpos = 1, as in JAX.  Points
outside [0, 1]^3 encode to 0 through ``torch.where``: no boolean indexing,
nothing that blocks the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from envidr_tpu_torch.ops.cp_rows import row_pair


@dataclasses.dataclass(frozen=True)
class CPSpec:
    """Static geometry of the CP encoder (the JAX package's spec, same
    fields, defaults and per-level arithmetic)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2                 # C of the output, per level
    rank: int = 32                     # CP rank per level
    base_resolution: int = 16
    desired_resolution: Optional[int] = 2048
    per_level_scale: float = 2.0
    compute_dtype: str = "bfloat16"    # 'bfloat16' | 'float32'
    formulation: str = "twohot"        # 'twohot' | 'take' (equal maths here)

    resolutions: Tuple[int, ...] = dataclasses.field(init=False)
    scales: Tuple[float, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.formulation not in ("twohot", "take"):
            raise ValueError(f"formulation {self.formulation!r}")
        s = self.per_level_scale
        if self.desired_resolution is not None:
            s = float(np.exp2(
                np.log2(self.desired_resolution / self.base_resolution)
                / max(self.num_levels - 1, 1)))
        resolutions, scales = [], []
        for lvl in range(self.num_levels):
            scale = float(np.exp2(lvl * np.log2(s)) * self.base_resolution - 1.0)
            resolutions.append(int(np.ceil(scale)) + 1)
            scales.append(scale)
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "scales", tuple(scales))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def rounds_bf16(self) -> bool:
        """Whether the lerp rounds as the JAX bf16 two-hot matmul does
        (``take`` is f32 in the JAX package whatever the dtype)."""
        return self.compute_dtype == "bfloat16" and self.formulation == "twohot"


def init_cp_params(spec: CPSpec, std: float = 0.1,
                   generator: Optional[torch.Generator] = None):
    """``{"axes": [[Tx, Ty, Tz] per level], "proj": [P per level]}``: tables
    ``[R_l, rank]`` ~ N(0, std), projections ``[rank, C]`` ~ N(0, 1/rank)."""
    axes, proj = [], []
    for R in spec.resolutions:
        axes.append([torch.randn(R, spec.rank, generator=generator) * std
                     for _ in range(spec.input_dim)])
        proj.append(torch.randn(spec.rank, spec.level_dim, generator=generator)
                    * (1.0 / np.sqrt(spec.rank)))
    return {"axes": axes, "proj": proj}


def _axis_feat(table: torch.Tensor, pos: torch.Tensor, R: int, bf16: bool) -> torch.Tensor:
    """Linear interpolation of a 1-D table: [B] x [R, rank] -> [B, rank] f32.

    ``bf16``: round as the JAX bf16 two-hot matmul (module docstring)."""
    i0f = torch.clamp(torch.floor(pos.detach()), 0, R - 2)
    i0 = i0f.long()
    frac = pos - i0f
    if bf16:
        w1 = frac.to(torch.bfloat16)
        w0 = (1.0 - w1).float()
        w1 = w1.float()
        table = table.to(torch.bfloat16).float()
    else:
        w0, w1 = 1.0 - frac, frac
    v0, v1 = row_pair(table, i0)
    return w0[:, None] * v0 + w1[:, None] * v1


def cp_encode(inputs: torch.Tensor, params, spec: CPSpec) -> torch.Tensor:
    """Encode inputs in [0, 1]^3 -> [..., L*C].  Out-of-bounds -> 0."""
    prefix = inputs.shape[:-1]
    x = inputs.reshape(-1, spec.input_dim)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)
    bf16 = spec.rounds_bf16
    feats = []
    for lvl in range(spec.num_levels):
        R, scale = spec.resolutions[lvl], spec.scales[lvl]
        prod = None
        for a in range(spec.input_dim):
            f = _axis_feat(params["axes"][lvl][a], x[:, a] * scale, R, bf16)
            prod = f if prod is None else prod * f
        feats.append(prod @ params["proj"][lvl])                 # [B, C]
    out = torch.cat(feats, dim=-1)
    out = torch.where(oob, torch.zeros((), device=out.device, dtype=out.dtype), out)
    return out.reshape(*prefix, spec.output_dim)


def cp_encode_from_world(xyz: torch.Tensor, params, spec: CPSpec,
                         bound: float = 1.0) -> torch.Tensor:
    return cp_encode((xyz + bound) / (2.0 * bound), params, spec)
