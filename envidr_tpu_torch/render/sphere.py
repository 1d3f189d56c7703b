"""Sphere-mode renderer: thin-shell sampling around an analytic sphere.

Counterpart of ``envidr_tpu/render/sphere.py`` (``run_sph``,
``sph_ray.py:34-221``): each ray takes a fixed shell of ``num_step`` samples
``step_size`` apart, centred on its entry into the sphere of ``radius``; rays
that miss it are masked (weights zeroed), not gathered, so every shape is
fixed.  No occupancy grid and no march.  The normals are autodiff gradients
of the SDF (:meth:`NeRFNetwork.geometry_with_normals`), differentiable
under ``training`` for the eikonal term's double backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from envidr_tpu_torch.geometry.rays import sphere_intersections
from envidr_tpu_torch.models.network import NeRFNetwork, _safe_normalize
from envidr_tpu_torch.ops.compositing import alphas_from_sigmas, weights_from_alphas


@dataclasses.dataclass(frozen=True)
class SphereRenderOptions:
    num_step: int = 12
    step_size: float = 0.002
    radius: float = 0.95          # opt.env_sph_radius
    density_scale: float = 1.0
    perturb: bool = False
    need_normals: bool = True     # any normal-dependent feature on
    training: bool = False
    with_surf_sdf: bool = False   # the sdf loss's surface samples (sph_ray.py:160-163)
    with_backsdf: bool = False    # the relsdf outputs (sph_ray.py:165-178)


def render_sphere(net: NeRFNetwork, opts: SphereRenderOptions, rays_o: torch.Tensor,
                  rays_d: torch.Tensor, bg_color, *, material=None, env_index=0,
                  r_images: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  level_mask: Optional[torch.Tensor] = None,
                  normal_anneal_ratio: float = 1.0, env_rot_radian=None) -> Dict[str, Any]:
    """Render N rays of the sphere.  ``bg_color`` is a scalar, [3] or
    [N, 3]; ``material`` a dict or a tensor [5] (roughness, metallic,
    colour); ``env_index`` an int or a 0-dim device tensor; ``r_images``
    [N, C] each ray's mirror-sphere colour (``train_renv``); ``noise``
    [N, num_step] in [0, 1) jitters the samples by up to half a step (used
    only with ``opts.perturb``); ``env_rot_radian`` turns the environment
    about the y axis.  The depth is normalised by the largest
    far distance of the batch, as the JAX package normalises it."""
    cfg = net.cfg
    N, S = rays_o.shape[0], opts.num_step
    dtype, dev = rays_o.dtype, rays_o.device
    if isinstance(bg_color, (int, float)):    # a fill: a copied number blocks the host
        bg = torch.full((N, 3), float(bg_color), dtype=dtype, device=dev)
    else:
        bg = torch.as_tensor(bg_color, dtype=dtype, device=dev).expand(N, 3)

    nears, fars, mask = sphere_intersections(rays_o, rays_d, opts.radius)
    maskf = mask.to(dtype)
    z_radius = opts.step_size * (S - 1) / 2.0
    z_vals = torch.linspace(-z_radius, z_radius, S, dtype=dtype, device=dev)[None, :] + nears
    if opts.perturb and noise is not None:
        z_vals = z_vals + (noise - 0.5) * opts.step_size
    dirs = rays_d[:, None, :]
    xyzs = rays_o[:, None, :] + dirs * z_vals[..., None]               # [N, S, 3]

    geo, normals, sdf_gradients = net.geometry_with_normals(
        xyzs, level_mask, need_normals=opts.need_normals,
        normal_anneal_ratio=normal_anneal_ratio, create_graph=opts.training,
        material=material)
    sdfs = geo["sdf"]
    roughness = geo["roughness"]
    if roughness is None:
        roughness = torch.full_like(sdfs[..., None], cfg.default_roughness)

    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], opts.step_size)], dim=-1)
    dirs_b = dirs.expand_as(xyzs)
    sigmas = opts.density_scale * net.sdf_to_sigma(sdfs, dirs=dirs_b, dists=deltas,
                                                   normals=normals)

    normals_enc, w_r_enc, n_dot_w_o, n_env_enc = net.get_color_mlp_extra_params(
        normals, dirs_b, roughness, env_rot_radian)
    if normals_enc is not None and not opts.training:
        normals_enc = normals_enc.detach()
    r_in = None if r_images is None else r_images[:, None, :].expand(N, S, r_images.shape[-1])
    rgbs, aux = net.forward_color(geo["geo_feat"], dirs_b, normals_enc, w_r_enc, n_dot_w_o,
                                  env_index=env_index, n_env_enc=n_env_enc, r_images=r_in,
                                  roughness=roughness, blend_weight=geo["blend_weight"])

    alphas = sigmas if cfg.use_neus_sdf else alphas_from_sigmas(sigmas, deltas)
    weights = weights_from_alphas(alphas) * maskf[:, None]                # misses -> 0
    weights_sum = weights.sum(dim=-1, keepdim=True)
    # depth normalised as sph_ray.py:112-115 normalises it
    ori_z = torch.clamp((z_vals - nears) / (fars.max() - nears), 0.0, 1.0)
    depth = (weights * ori_z).sum(dim=-1) * maskf
    w3 = weights[..., None]
    hit = mask[:, None]

    def image_of(c):
        return torch.where(hit, (w3 * c).sum(dim=-2) + (1.0 - weights_sum) * bg, bg)

    results: Dict[str, Any] = {"image": image_of(rgbs), "depth": depth,
                               "weights_sum": weights_sum[..., 0] * maskf, "sigmas": sigmas,
                               "sdfs": sdfs, "mask": mask}
    if sdf_gradients is not None:
        results["sdf_gradients"] = sdf_gradients
    zero = torch.zeros((), dtype=dtype, device=dev)
    if normals is not None:
        n_img = _safe_normalize((w3 * normals.detach()).sum(dim=-2))
        results["normal_image"] = torch.where(hit, n_img, zero)
    if cfg.use_diffuse and not cfg.diffuse_only:
        results["diffuse_image"] = image_of(aux["c_diffuse"])
        results["specular_image"] = image_of(aux["c_specular"])
    results["roughness_image"] = torch.where(hit, (w3 * roughness).sum(dim=-2), zero)

    if opts.with_surf_sdf:
        surf_xyzs = rays_o[:, None, :] + dirs * nears[..., None]
        surf = net.forward_geometry(surf_xyzs, level_mask, material=material)["sdf"]
        results["surf_sdfs"] = surf[..., 0] * maskf                       # [N]
    if opts.with_backsdf:
        results["relsdf"] = sdfs[..., 1:] - sdfs[..., :-1]
        results["sdf_weights"] = weights[..., :-1]
        results["sdf_dist"] = deltas[..., :-1]
        if normals is not None:
            results["cos"] = (dirs_b * normals.detach()).sum(dim=-1)[..., :-1]
    return results
