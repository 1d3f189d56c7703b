"""Loss assembly of the train step.

Counterpart of ``envidr_tpu/train/losses.py:compute_losses``: color,
diffuse, mask BCE, the SDF relation (``relsdf``), the distance bound,
back-face, orientation, Cauchy, entropy and eikonal terms, and sphere mode's
surface term (``sdf``: the mean |SDF| on the analytic sphere).

Every mean and sum over rays or samples goes through a :class:`RayReduce`:
on one rank the plain ``mean`` / ``sum``; over a process group the sum
across the ranks (``parallel/mesh.py:global_sum``), and a mean as that sum
over the global count, so that each rank computes the loss of the whole
batch (a ratio's denominator included) and its own share of the gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from envidr_tpu_torch.ops.density import laplace_density
from envidr_tpu_torch.parallel.mesh import Group, global_sum


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


DEFAULT_WEIGHTS = dict(
    color=1.0, diffuse=1.0, mask=0.0, relsdf=0.0, dist_bound=0.0, backsdf=0.0,
    orientation=0.0, cauchy=0.0, entropy=0.0, eikonal=0.0, sdf=0.0,
)


class RayReduce:
    """Sums and means over the rays (and their samples) of the global
    batch, whose ranks each hold equal shares."""

    def __init__(self, group: Optional[Group] = None):
        self.group = group if group is not None and group.sharded else None

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return global_sum(self.group, x.sum())

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return x.mean()
        return global_sum(self.group, x.sum()) / (x.numel() * self.group.world)


LOCAL = RayReduce()


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
                   beta: Optional[torch.Tensor] = None,
                   neus_inv_s: Optional[torch.Tensor] = None,
                   alpha_mask: Optional[torch.Tensor] = None,
                   diffuse_gt: Optional[torch.Tensor] = None,
                   roughness: Optional[torch.Tensor] = None,
                   reduce: RayReduce = LOCAL):
    """Returns (total_loss, per-term dict of detached scalars).

    ``beta`` (Laplace) or ``neus_inv_s`` (NeuS) is the density's sharpness,
    which the Cauchy and entropy terms read; ``roughness`` [N, K, 1] weights
    the Cauchy term under ``cauchy_roughness_weighted``; ``reduce`` forms
    the sums and means (over a process group, across its ranks)."""
    w = {**DEFAULT_WEIGHTS, **weights}
    mean, total = reduce.mean, reduce.sum
    terms: Dict[str, torch.Tensor] = {}

    color = mean(_color_err(outputs["image"], gt_rgb, flags.color_loss))
    loss = w["color"] * color
    terms["color"] = color

    if flags.use_diffuse_loss and diffuse_gt is not None:
        t = mean(_color_err(outputs["diffuse_image"], diffuse_gt, flags.color_loss))
        loss = loss + w["diffuse"] * t
        terms["diffuse"] = t

    if flags.use_mask_loss and alpha_mask is not None:
        ws = outputs["weights_sum"].clamp(1e-3, 1.0 - 1e-3)
        t = -mean(alpha_mask * torch.log(ws) + (1.0 - alpha_mask) * torch.log(1.0 - ws))
        loss = loss + w["mask"] * t
        terms["mask"] = t

    zero = torch.zeros((), device=gt_rgb.device)
    pm = outputs.get("point_mask")
    if pm is None and "relsdf" in outputs:
        # sphere mode: every consecutive-sample pair is valid (sph_ray.py:165-178)
        pm = torch.ones_like(outputs["relsdf"], dtype=torch.bool)

    if flags.use_relsdf_loss:
        l_d = (outputs["relsdf"] - outputs["est_relsdf"]) ** 2 * pm
        t = mean(l_d) if flags.relsdf_mode == "mean" else total(l_d)
        loss = loss + w["relsdf"] * t
        terms["relsdf"] = t

    if flags.use_dist_bound:
        l_db = F.relu(outputs["relsdf"].abs() - outputs["sdf_dist"]) ** 2
        t = total(l_db * pm)
        loss = loss + w["dist_bound"] * t
        terms["dist_bound"] = t

    if flags.use_backsdf_loss:
        # penalise an SDF that rises along the ray (back faces), utils.py:738-749
        wts, rel = outputs["sdf_weights"], outputs["relsdf"]
        m = pm & (wts > flags.backsdf_thresh) & (rel > 0)
        s_sq = rel ** 2
        r_cos_sq = s_sq / (outputs["sdf_dist"].clamp_min(5e-4) ** 2 + s_sq)
        num = total(torch.where(m, wts * r_cos_sq, zero))
        t = num if flags.backsdf_mode == "sum" else num / (1.0 + total(torch.where(m, wts, zero)))
        loss = loss + w["backsdf"] * t
        terms["backsdf"] = t

    if flags.use_orientation_loss:
        t = total(torch.where(pm, outputs["sdf_weights"] * F.relu(outputs["cos"]), zero))
        loss = loss + w["orientation"] * t
        terms["orientation"] = t

    reg_density = None
    if flags.use_cauchy_loss or flags.use_entropy_loss:
        if beta is not None:
            b = beta if flags.cauchy_undetach_beta else beta.detach()
            reg_density = laplace_density(outputs["sdfs"], b, 1.0)
        elif neus_inv_s is not None:
            # NeuS has no Laplace beta: the logistic CDF with the learned
            # sharpness, the JAX package's analogue (losses.py:145-153)
            s = neus_inv_s if flags.cauchy_undetach_beta else neus_inv_s.detach()
            reg_density = torch.sigmoid(-outputs["sdfs"] * s)
        else:
            raise ValueError("cauchy/entropy loss needs a density sharpness: pass beta "
                             "(Laplace) or neus_inv_s (NeuS)")

    if flags.use_cauchy_loss:
        # log1p of (1 - density)^2 pushes the density to 0 or 1 (utils.py:760-774)
        scale = 4.0
        rw = 1.0
        if flags.cauchy_roughness_weighted and roughness is not None:
            r = roughness.detach()[..., 0]
            rw = torch.sigmoid(0.5 * (1.0 / r.clamp(2e-2, 0.1) - 25.0)) * 10.0
        t = (1.0 / scale) * mean(torch.log1p((1.0 - reg_density) ** 2 * scale ** 2) * rw)
        loss = loss + w["cauchy"] * t
        terms["cauchy"] = t

    if flags.use_entropy_loss:
        wts = outputs["sdf_weights"]
        rd = reg_density[..., :-1] if reg_density.shape != wts.shape else reg_density
        m = (wts > 0.02) & (rd > 0.05) & (rd < 0.95)
        if pm is not None:
            m = m & pm
        t = total(torch.where(m, -torch.log(1.0 - rd + 1e-6) * wts, zero))
        loss = loss + w["entropy"] * t
        terms["entropy"] = t

    if flags.use_eikonal_loss:
        norms = torch.linalg.vector_norm(outputs["sdf_gradients"], dim=-1)
        if flags.weighted_eikonal and "weights" in outputs:
            norms = norms * outputs["weights"].detach()
        mask = outputs.get("mask")
        if mask is not None and mask.shape == norms.shape:
            # masked mean over the valid marched samples only
            t = total(torch.where(mask, (norms - 1.0) ** 2, zero)) / total(mask).clamp_min(1)
        else:
            t = mean((norms - 1.0) ** 2)
        loss = loss + w["eikonal"] * t
        terms["eikonal"] = t

    if flags.use_sdf_loss and "surf_sdfs" in outputs:
        t = mean(outputs["surf_sdfs"].abs())
        loss = loss + w["sdf"] * t
        terms["sdf"] = t

    return loss, {k: v.detach() for k, v in terms.items()}
