"""Per-epoch schedule resolver (counterpart of ``envidr_tpu/train/schedules.py``).

``resolve(opt, epoch)`` returns an immutable :class:`StepSchedule`: loss
structure gates, step budgets, loss weights and anneal ratios.  The port runs
eagerly, so every value is read afresh each step; nothing is frozen by a
compiler (ROADMAP C-4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from envidr_tpu_torch.config import Options
from envidr_tpu_torch.train.losses import LossFlags


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    flags: LossFlags                  # loss structure gates
    weights: Dict[str, float]
    diffuse_only: bool
    indir_ref: bool
    grad_rays: bool
    normal_anneal_ratio: float
    enabled_levels: int  # level mask vector
    beta_min: float
    early_stop_steps: int
    max_steps: int
    num_rays: int
    update_extra_interval: int
    cos_anneal_ratio: float = 1.0  # NeuS
    use_error_map: bool = False       # error-map importance sampling
    error_bound: bool = False         # VolSDF error-bound sampling

    def __post_init__(self):
        object.__setattr__(self, "weights", dict(self.weights))


def _exp_sched(sched: Tuple[float, ...], default: float, epoch: int) -> float:
    """[w_start, w_end, s_start, s_iters, s_stop] exponential anneal
    (utils.py:1771-1819)."""
    if not sched:
        return default
    w_start, w_end, s_start, s_iters, s_stop = sched
    iters = epoch - s_start
    if s_stop > 0 and s_stop <= iters:
        return 0.0
    if iters >= 0:
        return float(w_start * (w_end / w_start) ** min(iters / s_iters, 1.0))
    return default


def _step_sched(sched: Tuple[int, ...], default: int, epoch: int) -> int:
    """[v1, e1, v2, e2, ...]: value v_i applies once epoch >= e_i
    (utils.py:1827-1861)."""
    val = default
    pairs = list(sched)
    while len(pairs) >= 2 and epoch >= pairs[1]:
        val = int(pairs[0])
        pairs = pairs[2:]
    return val


def resolve(opt: Options, epoch: int, global_step: int = 0) -> StepSchedule:
    def started(weight, start):
        return weight > 0 and epoch >= start

    w = dict(
        color=opt.color_loss_weight,
        diffuse=opt.diffuse_loss_weight,
        mask=opt.mask_loss_weight,
        relsdf=_exp_sched(opt.relsdf_loss_weight_sched, opt.relsdf_loss_weight, epoch),
        dist_bound=opt.dist_bound_weight,
        backsdf=_exp_sched(opt.backsdf_loss_weight_sched, opt.backsdf_loss_weight, epoch),
        orientation=_exp_sched(opt.orientation_loss_weight_sched,
                               opt.orientation_loss_weight, epoch),
        cauchy=_exp_sched(opt.cauchy_loss_weight_sched, opt.cauchy_loss_weight, epoch),
        entropy=opt.entropy_loss_weight,
        eikonal=_exp_sched(opt.eikonal_loss_weight_sched, opt.eikonal_loss_weight, epoch),
        sdf=opt.sdf_loss_weight,
    )

    flags = LossFlags(
        color_loss=opt.color_loss,
        use_diffuse_loss=opt.diffuse_loss and opt.diffuse_loss_weight > 0,
        use_mask_loss=started(opt.mask_loss_weight, opt.mask_loss_start_iter),
        use_relsdf_loss=started(opt.relsdf_loss_weight, opt.relsdf_loss_start_iter),
        use_dist_bound=started(opt.dist_bound_weight, opt.dist_bound_start_iter),
        use_backsdf_loss=started(opt.backsdf_loss_weight, opt.backsdf_loss_start_iter),
        use_orientation_loss=started(opt.orientation_loss_weight,
                                     opt.orientation_loss_start_iter),
        use_cauchy_loss=started(opt.cauchy_loss_weight, opt.cauchy_loss_start_iter),
        use_entropy_loss=opt.entropy_loss_weight > 0,
        use_eikonal_loss=started(opt.eikonal_loss_weight, opt.eikonal_loss_start_iter),
        use_sdf_loss=opt.env_sph_mode and opt.sdf_loss_weight > 0,
        relsdf_mode=opt.relsdf_mode,
        backsdf_mode=opt.backsdf_mode,
        backsdf_thresh=opt.backsdf_thresh,
        cauchy_undetach_beta=opt.cauchy_undetach_beta,
        cauchy_roughness_weighted=opt.cauchy_roughness_weighted,
        weighted_eikonal=opt.weighted_eikonal,
    )

    diffuse_only = opt.color_net_start_iter > epoch
    indir_ref = opt.indir_ref_start_iter > 0 and opt.indir_ref_start_iter <= epoch
    grad_rays = bool(
        indir_ref and opt.grad_rays_start_iter > 0
        and epoch - opt.indir_ref_start_iter > opt.grad_rays_start_iter)

    normal_anneal = 1.0
    if opt.normal_anneal_iters > 0:
        normal_anneal = min(epoch / opt.normal_anneal_iters, 1.0)

    enabled_levels = opt.enabled_levels
    if opt.enabled_levels_sched:
        base_level, s_start, s_iters = opt.enabled_levels_sched
        iters = epoch - s_start
        if iters >= 0:
            enabled_levels = int(base_level + (opt.num_levels - base_level)
                                 * min(iters / s_iters, 1.0))
        else:
            enabled_levels = int(base_level)

    beta_min = opt.beta_min
    if opt.use_sdf and opt.beta_min_sched:
        bm_s, bm_e, bm_iters = opt.beta_min_sched
        beta_min = float(bm_s * (bm_e / bm_s) ** min(epoch / bm_iters, 1.0))

    cos_anneal = opt.cos_anneal_ratio
    if opt.use_neus_sdf and opt.cos_anneal_steps > 0:
        cos_anneal = min(1.0, global_step / opt.cos_anneal_steps)

    update_interval = opt.update_extra_interval
    if 0 <= opt.update_extra_before <= epoch:
        update_interval = -1

    # per-epoch scalars also ride the weights dict under reserved "_" keys,
    # as in the JAX package
    w["_beta_min"] = beta_min
    beta_cap = opt.beta_max
    if opt.beta_cap_sched:
        bc_s, bc_e, bc_it = opt.beta_cap_sched
        beta_cap = float(bc_s * (bc_e / bc_s) ** min(epoch / bc_it, 1.0))
    w["_beta_cap"] = beta_cap
    w["_cos_anneal"] = cos_anneal
    w["_normal_anneal"] = normal_anneal
    w["_levels"] = float(enabled_levels if 0 < enabled_levels else opt.num_levels)

    return StepSchedule(
        flags=flags, weights=w, diffuse_only=diffuse_only, indir_ref=indir_ref,
        grad_rays=grad_rays, normal_anneal_ratio=normal_anneal,
        enabled_levels=enabled_levels, beta_min=beta_min,
        early_stop_steps=_step_sched(opt.early_stop_steps_sched,
                                     opt.early_stop_steps, epoch),
        max_steps=_step_sched(opt.max_steps_sched, opt.max_steps, epoch),
        num_rays=_step_sched(opt.num_rays_sched, opt.num_rays, epoch),
        update_extra_interval=update_interval,
        cos_anneal_ratio=cos_anneal,
        use_error_map=(opt.error_map and epoch >= opt.error_map_start_iter),
        # error_bound_start_iter gates the VolSDF sampler per epoch
        # (utils.py:1740-1743): before the start epoch it is forced off,
        # after it forced on; with no start iter the static flag rules
        error_bound=(False if opt.error_bound_start_iter > epoch else
                     True if opt.error_bound_start_iter > 0 else
                     opt.error_bound_sample),
    )


def lr_lambda(global_step: int, iters: int) -> float:
    """The reference's LambdaLR: 0.1 ** min(step/iters, 1) (main_nerf.py:158)."""
    return 0.1 ** min(global_step / iters, 1.0)


def level_mask(enabled_levels: int, num_levels: int, device=None) -> Optional[torch.Tensor]:
    if enabled_levels <= 0 or enabled_levels >= num_levels:
        return None
    return (torch.arange(num_levels, device=device) < enabled_levels).float()
