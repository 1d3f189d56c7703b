"""Interreflection (``indir_ref``) three-pass render.

Counterpart of ``envidr_tpu/render/indirect.py`` (the reference's masked
three-pass flow, renderer.py:437-513):

  pass 1  geometry only   -> normal image, depth and opacity of each ray
  pass 2  reflected rays  -> each ray's reflection colour and visibility
  pass 3  main render     -> the renv branch blends the reflection in

Every pass renders all rays.  Where the reference gathers the rays that hit
a surface with boolean masks, the masks here stay dense per-ray tensors: a
secondary ray whose mask is off carries a zero reflection image with zero
visibility, which routes it through the plain env branch of the colour head.
So the shapes do not depend on the data and nothing reads a mask back on the
host (a boolean index would block the host every step).

Each pass is a span (``obs.py``) holding its ``render``:
``indirect.geometry``, ``indirect.reflect`` and ``indirect.main``.  The
counters: ``indirect.rays`` (N), ``indirect.ref_rays`` (the rays whose
reflection mask is on), ``indirect.geometry.samples`` (pass 1's marched
samples), ``indirect.reflect.slots`` (N times pass 2's budget) and
``indirect.reflect.samples`` (its marched samples); the device sums are
kept as tensors and read at ``obs.snapshot()``.  Pass 3's slots and samples
are the trainer's ``march.slots`` and ``march.samples``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.geometry.rays import reflect_dir
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops.density import SQRT3
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene


@dataclasses.dataclass(frozen=True)
class IndirectOptions:
    indir_max_steps: int = 1024
    indir_early_stop_steps: int = 32
    indir_num_samples: int = 32      # K budget of the secondary pass
    grad_rays: bool = False
    grad_rays_scale: float = 0.01


def render_scene_indirect(net: NeRFNetwork, opts: SceneRenderOptions, iopts: IndirectOptions,
                          bitfield: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          bg_color, aabb: torch.Tensor, *,
                          noise: Optional[Sequence[torch.Tensor]] = None,
                          strat_noise: Optional[Sequence[torch.Tensor]] = None,
                          obj_aabb: Optional[torch.Tensor] = None,
                          level_mask: Optional[torch.Tensor] = None,
                          normal_anneal_ratio: float = 1.0, cos_anneal_ratio: float = 1.0,
                          beta_cap=None, beta_min=None,
                          env_rot_radian=None) -> Dict[str, Any]:
    """The three passes over N rays.  ``noise`` and ``strat_noise`` hold one
    draw per pass (as :func:`render_scene` takes them; pass 2's
    ``strat_noise`` is [N, iopts.indir_num_samples]); ``obj_aabb`` [6] keeps
    the reflection of surface points outside it off; ``env_rot_radian``
    turns the environment of passes 2 and 3.  Returns pass 3's
    results with pass 1's ``normal_image`` and ``depth`` and the per-ray
    ``ref_mask``, ``ray_mask`` and ``r_images`` [N, 4]."""
    dt = 2.0 * SQRT3 / iopts.indir_max_steps
    noise = noise if noise is not None else (None,) * 3
    strat_noise = strat_noise if strat_noise is not None else (None,) * 3
    shared = dict(level_mask=level_mask, normal_anneal_ratio=normal_anneal_ratio,
                  cos_anneal_ratio=cos_anneal_ratio, beta_cap=beta_cap, beta_min=beta_min)

    N = rays_o.shape[0]
    obs.count("indirect.rays", N)

    # pass 1: geometry only (renderer.py:442-447)
    with obs.span("indirect.geometry"):
        geo = render_scene(net, dataclasses.replace(opts, geometry_only=True,
                                                    with_loss_aux=False),
                           bitfield, rays_o, rays_d, bg_color, aabb, noise=noise[0],
                           strat_noise=strat_noise[0], **shared)
    obs.count_later("indirect.geometry.samples", geo["counts"])
    normals = geo["normal_image"]
    depth = geo["depth"] - dt
    weights_sum = geo["weights_sum"]
    ref_mask = (depth != 0.0) & (weights_sum > 0.9)
    ray_mask = (depth != 0.0) & (weights_sum > 0.3)
    ref_o = rays_o + depth[:, None] * rays_d
    ref_d = reflect_dir(-rays_d, normals)
    if obj_aabb is not None:
        inside = (ref_o > obj_aabb[:3]).all(-1) & (ref_o < obj_aabb[3:]).all(-1)
        ref_mask = ref_mask & inside
    obs.count_later("indirect.ref_rays", ref_mask)

    # pass 2: the reflected rays on a black background (renderer.py:462-474)
    sec_opts = dataclasses.replace(
        opts, max_steps=iopts.indir_max_steps, early_stop_steps=iopts.indir_early_stop_steps,
        num_samples=iopts.indir_num_samples, min_near=dt * 2.0, geometry_only=False,
        with_loss_aux=False, grad_ray=iopts.grad_rays, grad_rays_scale=iopts.grad_rays_scale,
        use_bg_net=False)
    with obs.span("indirect.reflect"):
        sec = render_scene(net, sec_opts, bitfield, ref_o, ref_d, 0.0, aabb, noise=noise[1],
                           strat_noise=strat_noise[1], env_rot_radian=env_rot_radian, **shared)
    obs.count("indirect.reflect.slots", N * iopts.indir_num_samples)
    obs.count_later("indirect.reflect.samples", sec["counts"])
    r_images = torch.cat([sec["image"], sec["weights_sum"][:, None]], dim=-1)
    r_images = torch.where(ref_mask[:, None], r_images, torch.zeros((), device=r_images.device))

    # pass 3: the main render, fed with the reflection image.  Passes 2 and 3
    # composite onto their bg_color, never onto the background net
    main_opts = dataclasses.replace(opts, geometry_only=False, use_bg_net=False)
    with obs.span("indirect.main"):
        results = render_scene(net, main_opts, bitfield, rays_o, rays_d, bg_color, aabb,
                               noise=noise[2], strat_noise=strat_noise[2], r_images=r_images,
                               env_rot_radian=env_rot_radian, **shared)
    results.update(normal_image=normals, depth=depth, ref_mask=ref_mask, ray_mask=ray_mask,
                   r_images=r_images)
    return results
