"""Loss assembly of the scene train step.

Counterpart of ``envidr_tpu/train/losses.py:compute_losses`` for the terms
the scene configs of this slice turn on: the color term, the diffuse term,
the mask BCE and the eikonal term.  The SDF-relation, back-face,
orientation, Cauchy, entropy and sphere-surface terms raise until ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LossFlags:
    """Static structure gates (the JAX package's LossFlags, same fields)."""

    color_loss: str = "l1"          # 'l1' | 'l2' | 'huber' | 'relativel2'
    use_diffuse_loss: bool = False
    use_mask_loss: bool = False
    use_relsdf_loss: bool = False
    use_dist_bound: bool = False
    use_backsdf_loss: bool = False
    use_orientation_loss: bool = False
    use_cauchy_loss: bool = False
    use_entropy_loss: bool = False
    use_eikonal_loss: bool = False
    use_sdf_loss: bool = False
    relsdf_mode: str = "mean"
    backsdf_mode: str = "sum"
    backsdf_thresh: float = 0.1
    cauchy_undetach_beta: bool = False
    cauchy_roughness_weighted: bool = False
    weighted_eikonal: bool = False

    def unported(self):
        names = ("use_relsdf_loss", "use_dist_bound", "use_backsdf_loss",
                 "use_orientation_loss", "use_cauchy_loss", "use_entropy_loss",
                 "use_sdf_loss")
        return [n for n in names if getattr(self, n)]


DEFAULT_WEIGHTS = dict(
    color=1.0, diffuse=1.0, mask=0.0, relsdf=0.0, dist_bound=0.0, backsdf=0.0,
    orientation=0.0, cauchy=0.0, entropy=0.0, eikonal=0.0, sdf=0.0,
)


def _color_err(pred, gt, kind: str):
    if kind == "l1":
        return (pred - gt).abs()
    if kind == "l2":
        return (pred - gt) ** 2
    if kind == "huber":
        d = (pred - gt).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    if kind == "relativel2":
        return (pred - gt) ** 2 / (pred.detach() ** 2 + 1e-2)
    raise ValueError(kind)


def compute_losses(outputs: Dict[str, Any], gt_rgb: torch.Tensor, flags: LossFlags,
                   weights: Dict[str, float], *,
                   neus_inv_s: Optional[torch.Tensor] = None,
                   alpha_mask: Optional[torch.Tensor] = None,
                   diffuse_gt: Optional[torch.Tensor] = None):
    """Returns (total_loss, per-term dict of detached scalars).

    ``neus_inv_s`` is the NeuS sharpness; only the Cauchy and entropy terms
    read it, and they raise until ported."""
    unported = flags.unported()
    if unported:
        raise NotImplementedError(f"loss terms not ported yet: {unported}")
    w = {**DEFAULT_WEIGHTS, **weights}
    terms: Dict[str, torch.Tensor] = {}

    color = _color_err(outputs["image"], gt_rgb, flags.color_loss).mean()
    loss = w["color"] * color
    terms["color"] = color

    if flags.use_diffuse_loss and diffuse_gt is not None:
        t = _color_err(outputs["diffuse_image"], diffuse_gt, flags.color_loss).mean()
        loss = loss + w["diffuse"] * t
        terms["diffuse"] = t

    if flags.use_mask_loss and alpha_mask is not None:
        ws = outputs["weights_sum"].clamp(1e-3, 1.0 - 1e-3)
        t = -(alpha_mask * torch.log(ws) + (1.0 - alpha_mask) * torch.log(1.0 - ws)).mean()
        loss = loss + w["mask"] * t
        terms["mask"] = t

    if flags.use_eikonal_loss:
        norms = torch.linalg.vector_norm(outputs["sdf_gradients"], dim=-1)
        if flags.weighted_eikonal and "weights" in outputs:
            norms = norms * outputs["weights"].detach()
        mask = outputs.get("mask")
        if mask is not None and mask.shape == norms.shape:
            # masked mean over the valid marched samples only
            t = torch.where(mask, (norms - 1.0) ** 2, torch.zeros((), device=norms.device)
                            ).sum() / mask.sum().clamp_min(1)
        else:
            t = ((norms - 1.0) ** 2).mean()
        loss = loss + w["eikonal"] * t
        terms["eikonal"] = t

    return loss, {k: v.detach() for k, v in terms.items()}
