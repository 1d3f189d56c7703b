"""Scene-mode renderer: occupancy-grid march, fixed sample budget, composite.

Counterpart of ``envidr_tpu/render/scene.py:render_scene``.  With
``use_bg_net`` (and ``bg_radius > 0``) the background behind each ray is the
background net's colour where the ray leaves the background sphere
(``sphere_bg``).  The indirect pass
(``render/indirect.py``) calls it three times: ``geometry_only`` (the
normal image, depth and opacity; no colour), then on the reflected rays
with ``grad_ray`` (image gradients reach the secondary rays' origins), then
with ``r_images``, each ray's reflected colour and visibility, which the
colour head's renv branch reads.  Under NeuS (``use_neus_sdf``) the network returns
alphas, composited as they are, and the normals are always computed: the
alpha reads them.  A density field (``use_sdf=False``) gives sigmas directly
and ``sdfs = -sigma``.  ``with_loss_aux`` adds the consecutive-sample SDF
relations the auxiliary losses read; ``stratified_sampling`` jitters the
marched samples instead of the march.

A training render with ``pack`` runs the per-sample work (the encode, the
SDF net and its normals, the density, IDE and the colour MLPs, and their
backward) on the march's filled slots alone, packed into one flat batch
(``ops/marching.py:SlotPacking``, one host read of the filled count), and
scatters its outputs back to the [N, K] slots, zero at the empty ones.  The
composite and every consumer that reads no empty slot then see what the
dense render gives them.  The counters ``march.pack.rows`` and
``march.pack.slots`` (the packed rows, padding included, and N x K of the
calls that packed) and ``march.pack.dense`` (training renders that did not)
count it.

A call is the span ``render`` (``obs.py``), with the children ``march``,
``march.pack`` (packing only: the read, the gathers and the scatters; the
scatters under ``composite``), ``geometry`` (the position encode and the
normals), ``composite`` (alphas and weights), ``color`` and ``composite``
(the images).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.geometry.rays import near_far_from_aabb, sph_from_ray
from envidr_tpu_torch.models.network import NeRFNetwork, _safe_normalize
from envidr_tpu_torch.ops.compositing import alphas_from_sigmas, weights_from_alphas
from envidr_tpu_torch.ops.marching import DenseSlots, SlotPacking, march_rays


@dataclasses.dataclass(frozen=True)
class SceneRenderOptions:
    max_steps: int = 1024
    num_samples: int = 128          # K: per-ray sample budget
    early_stop_steps: int = -1
    dt_gamma: float = 0.0
    T_thresh: float = 1e-4
    density_scale: float = 1.0
    min_near: float = 0.2
    grid_size: int = 128
    perturb: bool = False
    training: bool = False
    need_normals: bool = True
    coarse_march: bool = False      # two-level march (ops/marching.py)
    with_loss_aux: bool = False     # relsdf/backsdf/orientation sample outputs
    # per-sample stratified jitter after the march instead of perturbing the
    # march itself (cuda_ray.py:78-88)
    stratified_sampling: bool = False
    geometry_only: bool = False     # normals, depth and opacity only
    grad_ray: bool = False          # secondary-ray gradient re-attachment
    grad_rays_scale: float = 0.01
    use_bg_net: bool = False        # the background net behind the rays
    # a training render runs the per-sample work on the march's filled slots
    # alone, packed (ops/marching.py:SlotPacking); the trainer decides
    pack: bool = False


def render_scene(net: NeRFNetwork, opts: SceneRenderOptions, bitfield: torch.Tensor,
                 rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color,
                 aabb: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
                 strat_noise: Optional[torch.Tensor] = None,
                 level_mask: Optional[torch.Tensor] = None,
                 normal_anneal_ratio: float = 1.0, cos_anneal_ratio: float = 1.0,
                 beta_cap=None, beta_min=None,
                 r_images: Optional[torch.Tensor] = None,
                 env_rot_radian=None) -> Dict[str, Any]:
    """Render N rays.  ``noise`` [N] in [0, 1) perturbs the march start (used
    only when ``opts.perturb`` and not ``opts.stratified_sampling``);
    ``strat_noise`` [N, K] in [0, 1) jitters each sample by up to half a base
    step (used only when ``opts.training`` and ``opts.stratified_sampling``);
    ``bg_color`` is a scalar, [3] or [N, 3]; ``cos_anneal_ratio`` is NeuS's
    (1 at eval); ``beta_cap`` (a tensor) bounds the Laplace beta from above;
    ``r_images`` [N, C] is each ray's reflection image (C = 3 or 4);
    ``env_rot_radian`` turns the environment about the y axis."""
    with obs.span("render"):
        cfg = net.cfg
        N, K = rays_o.shape[0], opts.num_samples
        nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, opts.min_near)
        if opts.use_bg_net and cfg.bg_radius > 0:
            bg = net.background_color(sph_from_ray(rays_o, rays_d, cfg.bg_radius), rays_d)
        elif isinstance(bg_color, (int, float)):    # a fill: a copied number blocks the host
            bg = torch.full((N, 3), float(bg_color), dtype=rays_o.dtype, device=rays_o.device)
        else:
            bg = torch.as_tensor(bg_color, dtype=rays_o.dtype, device=rays_o.device).expand(N, 3)

        with obs.span("march"):
            m = march_rays(rays_o, rays_d, nears, fars, bitfield, bound=cfg.bound,
                           grid_size=opts.grid_size, dt_gamma=opts.dt_gamma,
                           max_steps=opts.max_steps, num_samples=K,
                           early_stop_steps=opts.early_stop_steps,
                           noise=noise if opts.perturb and not opts.stratified_sampling
                           else None, coarse_march=opts.coarse_march)
        xyzs, dts = m.xyzs, m.dts
        if opts.stratified_sampling and opts.training and strat_noise is not None:
            # roll-differenced noise: consecutive segment lengths stay consistent
            # while each sample moves within +-0.5 dt_base (scene.py:104-113)
            dt_base = 2.0 * 1.7320508075688772 / opts.max_steps
            jitter = (strat_noise * 2.0 - 1.0) * 0.5 * dt_base
            strat = torch.roll(jitter, 1, dims=1) - jitter
            dts = dts + strat
            xyzs = xyzs + strat[..., None] * rays_d[:, None, :]
        # the rows of the per-sample work: every slot, or the filled ones packed
        if opts.training and opts.pack:
            rows = SlotPacking(m.mask)
        else:
            rows = DenseSlots(N, K)
            if opts.training:
                obs.count("march.pack.dense")
        p_xyzs, p_dts = rows.gather(xyzs), rows.gather(dts)
        if opts.grad_ray:
            # re-attach the samples to the ray origins so that image gradients
            # reach the secondary rays' origins (cuda_ray.py:100-105)
            s = opts.grad_rays_scale
            p_o = rows.per_ray(rays_o)
            p_xyzs = p_xyzs - s * p_o.detach() + s * p_o
        p_dirs = rows.per_ray(rays_d)

        # the color MLPs need normals whenever a normal-derived feature is on
        need_normals = opts.need_normals or (not opts.geometry_only and (
            cfg.normal_with_mlp or cfg.use_reflected_dir or cfg.use_n_dot_viewdir
            or cfg.diffuse_with_env)) or cfg.use_neus_sdf
        with obs.span("geometry"):
            geo, p_normals, p_grads = net.geometry_with_normals(
                p_xyzs, level_mask, need_normals=need_normals,
                normal_anneal_ratio=normal_anneal_ratio, create_graph=opts.training)
        p_sdfs = geo["sdf"] if cfg.use_sdf else -geo["sigma"]
        p_rough = geo["roughness"]
        if p_rough is None:
            p_rough = torch.full_like(p_sdfs[..., None], cfg.default_roughness)

        with obs.span("composite"):       # alphas and weights
            if cfg.use_sdf:
                p_sigmas = net.sdf_to_sigma(
                    p_sdfs, dirs=p_dirs, dists=p_dts, normals=p_normals,
                    cos_anneal_ratio=cos_anneal_ratio, beta_cap=beta_cap, beta_min=beta_min)
            else:
                p_sigmas = geo["sigma"]
            sigmas, sdfs, normals, sdf_gradients, roughness = rows.slots(
                p_sigmas, p_sdfs, p_normals, p_grads, p_rough)
            zero = torch.zeros((), device=sigmas.device)
            sigmas = torch.where(m.mask, opts.density_scale * sigmas, zero)
            alphas = sigmas if cfg.use_neus_sdf else alphas_from_sigmas(sigmas, dts)
            weights = weights_from_alphas(alphas, T_thresh=opts.T_thresh)
            weights = torch.where(m.mask, weights, zero)
            weights_sum = weights.sum(dim=-1)
            depth = (weights * m.z_vals).sum(dim=-1)
            depth = (depth + nears) * (depth != 0.0)

            results: Dict[str, Any] = {"weights_sum": weights_sum, "depth": depth,
                                       "sigmas": sigmas, "sdfs": sdfs, "counts": m.counts,
                                       "mask": m.mask}
            if sdf_gradients is not None:
                results["sdf_gradients"] = torch.where(m.mask[..., None], sdf_gradients, zero)
                results["weights"] = weights
            w3 = weights[..., None]

            if opts.geometry_only:
                # the normals are not detached: the indirect pass reflects about
                # this image.  The smooth normalisation keeps the backward finite
                # where a background ray composites an exactly-zero normal
                # (scene.py:165-176)
                results["normal_image"] = _safe_normalize((w3 * normals).sum(dim=-2))
                if opts.use_bg_net:
                    results["sphere_bg"] = bg
                return results

        with obs.span("color"):
            normals_enc, w_r_enc, n_dot_w_o, n_env_enc = net.get_color_mlp_extra_params(
                p_normals, p_dirs, p_rough, env_rot_radian)
            p_rgbs, aux = net.forward_color(
                geo["geo_feat"], p_dirs, normals_enc, w_r_enc, n_dot_w_o, n_env_enc=n_env_enc,
                # a padding row reflects nothing, so the renv gate stays shut there
                r_images=None if r_images is None else rows.per_ray(r_images, pad_zero=True),
                roughness=p_rough, blend_weight=geo["blend_weight"])

        with obs.span("composite"):       # the images
            rgbs, c_diffuse, c_specular, renv_mask = rows.slots(
                p_rgbs, aux["c_diffuse"], aux["c_specular"], aux.get("renv_mask"))
            results["image"] = (w3 * rgbs).sum(dim=-2) + (1.0 - weights_sum[..., None]) * bg
            if normals is not None:
                # smooth normalisation: background rays composite to an exactly-zero
                # normal, where the hard max-guard's backward is 0/0
                results["normal_image"] = _safe_normalize((w3 * normals.detach()).sum(dim=-2))
            if cfg.use_diffuse and not cfg.diffuse_only:
                results["diffuse_image"] = ((w3 * c_diffuse).sum(dim=-2)
                                            + (1.0 - weights_sum[..., None]) * bg)
                results["specular_image"] = ((w3 * c_specular).sum(dim=-2)
                                             + (1.0 - weights_sum[..., None]) * bg)
            results["roughness_image"] = (w3 * roughness).sum(dim=-2)
            results["roughness"] = roughness
            if renv_mask is not None:       # where the indirect branch is live
                results["renv_mask"] = renv_mask & m.mask
                results["renv_mask_image"] = (weights * renv_mask.float()).sum(dim=-1)

            if opts.with_loss_aux:
                # consecutive-sample SDF relations (cuda_ray.py:173-211), compacted:
                # slots k and k+1 of a ray are consecutive marched samples
                gap = m.ts[..., 1:] - m.ts[..., :-1]
                # continuity: the gap is under 1.2 dt of the next sample (no voxel skipped)
                point_mask = m.mask[..., :-1] & m.mask[..., 1:] & (gap < 1.2 * dts[..., 1:])
                cos = ((rays_d[:, None, :] * normals.detach()).sum(dim=-1)
                       if normals is not None else torch.zeros_like(sdfs))
                results.update(relsdf=sdfs[..., 1:] - sdfs[..., :-1],
                               est_relsdf=gap * cos[..., :-1], cos=cos[..., :-1],
                               point_mask=point_mask, sdf_weights=weights[..., :-1],
                               sdf_dist=gap)
            if opts.use_bg_net:
                results["sphere_bg"] = bg
            return results
