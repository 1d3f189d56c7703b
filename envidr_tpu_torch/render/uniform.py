"""Grid-free uniform + importance-sampled volume rendering.

Counterpart of ``envidr_tpu/render/uniform.py``: stratified uniform samples
in [near, far], optional upsampling by the inverse CDF of the coarse weights
(:func:`sample_pdf`, which VolSDF's sampler shares), one density + colour
query, compositing.  As in the JAX package, the upsampled positions stay
differentiable (the coarse weights reach the image through them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from envidr_tpu_torch.geometry.rays import near_far_from_aabb
from envidr_tpu_torch.models.network import NeRFNetwork, _safe_normalize
from envidr_tpu_torch.ops.compositing import alphas_from_sigmas, weights_from_alphas


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, det: bool = False,
               *, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF draws of new z values (``render_func/utils.py:4-38``):
    ``bins`` [N, T+1] edges, ``weights`` [N, T] -> [N, n_samples].

    ``u`` [N, n_samples] in [0, 1) are the draws; without it they are
    ``linspace(0.5/S, 1 - 0.5/S)`` with ``det``, else uniform from
    ``generator``.  Each draw's bin is found by a search of the CDF (the
    count of CDF values at or below it), not by the JAX package's
    ``[N, T+1, S]`` comparison."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)         # [N, T+1]
    if u is None:
        shape = cdf.shape[:-1] + (n_samples,)
        if det:
            u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                               dtype=cdf.dtype, device=cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    last = cdf.shape[-1] - 1
    below = torch.clamp(idx - 1, 0, last)
    above = torch.clamp(idx, 0, last)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    nb = bins.shape[-1] - 1
    bin_b = torch.gather(bins, -1, torch.clamp(below, 0, nb))
    bin_a = torch.gather(bins, -1, torch.clamp(above, 0, nb))
    span = cdf_a - cdf_b
    denom = torch.where(span < 1e-5, torch.ones_like(span), span)
    return bin_b + (u - cdf_b) / denom * (bin_a - bin_b)


@dataclasses.dataclass(frozen=True)
class UniformRenderOptions:
    num_steps: int = 128
    upsample_steps: int = 0
    min_near: float = 0.2
    density_scale: float = 1.0
    perturb: bool = False
    training: bool = False
    T_thresh: float = 0.0


def render_uniform(net: NeRFNetwork, opts: UniformRenderOptions, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, bg_color, aabb: torch.Tensor, *,
                   noise: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, env_index=0, material=None,
                   level_mask=None) -> Dict[str, Any]:
    """Render N rays with ``num_steps`` uniform samples and, with
    ``upsample_steps``, as many again drawn from the coarse weights.
    ``noise`` [N, num_steps] in [0, 1) jitters the samples under
    ``perturb``; ``u`` [N, upsample_steps] are the upsampling's draws when
    ``training`` (else they are deterministic), drawn from ``generator``
    when not given.  Positions are clipped to ``+-bound`` (VolSDF clips to
    the aabb)."""
    cfg = net.cfg
    N, T = rays_o.shape[0], opts.num_steps
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, opts.min_near)
    miss = fars > 1e9
    nears = torch.where(nears > 1e9, torch.full_like(nears, 2.0), nears)   # a dummy interval
    fars_c = torch.where(miss, torch.full_like(fars, 2.0 + 1e-3), fars)
    z = torch.linspace(0.0, 1.0, T, device=rays_o.device)
    z_vals = nears[:, None] + (fars_c - nears)[:, None] * z[None, :]
    if opts.perturb and noise is not None:
        z_vals = z_vals + (noise - 0.5) * ((fars_c - nears)[:, None] / T)

    def positions(zv):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        return torch.clamp(xyz, -cfg.bound, cfg.bound)

    def with_last(deltas):
        return torch.cat([deltas, torch.full_like(deltas[..., :1], 1e4)], dim=-1)

    if opts.upsample_steps > 0:
        geo = net.forward_geometry(positions(z_vals), level_mask, material=material)
        sig_c = net.sdf_to_sigma(geo["sdf"]) if cfg.use_sdf else geo["sigma"]
        w_c = weights_from_alphas(alphas_from_sigmas(
            opts.density_scale * sig_c, with_last(torch.diff(z_vals, dim=-1))))
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        bins = torch.cat([z_vals[..., :1], mids, z_vals[..., -1:]], dim=-1)
        new_z = sample_pdf(bins, w_c, opts.upsample_steps, det=not opts.training,
                           generator=generator, u=u if opts.training else None)
        z_vals = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1).values

    xyz = positions(z_vals)
    dirs = rays_d[:, None, :].expand_as(xyz)
    geo, normals, sdf_gradients = net.geometry_with_normals(
        xyz, level_mask, create_graph=torch.is_grad_enabled(), material=material)
    if cfg.use_sdf:
        sigmas = net.sdf_to_sigma(geo["sdf"], dirs=dirs,
                                  dists=torch.gradient(z_vals, dim=-1)[0], normals=normals)
    else:
        sigmas = geo["sigma"]
    sigmas = torch.where(miss[:, None], torch.zeros((), device=sigmas.device),
                         opts.density_scale * sigmas)
    roughness = geo["roughness"]
    if roughness is None:
        roughness = torch.full_like(sigmas[..., None], cfg.default_roughness)
    normals_enc, w_r_enc, n_dot_w_o, n_env_enc = net.get_color_mlp_extra_params(
        normals, dirs, roughness)
    rgbs, _ = net.forward_color(geo["geo_feat"], dirs, normals_enc, w_r_enc, n_dot_w_o,
                                env_index=env_index, n_env_enc=n_env_enc, roughness=roughness,
                                blend_weight=geo["blend_weight"])
    deltas = with_last(torch.diff(z_vals, dim=-1))
    alphas = sigmas if cfg.use_neus_sdf else alphas_from_sigmas(sigmas, deltas)
    weights = weights_from_alphas(alphas, T_thresh=opts.T_thresh)
    weights_sum = weights.sum(dim=-1)
    bg = torch.as_tensor(bg_color, dtype=rays_o.dtype, device=rays_o.device).expand(N, 3)
    w3 = weights[..., None]
    return {"image": (w3 * rgbs).sum(dim=-2) + (1.0 - weights_sum[..., None]) * bg,
            "depth": (weights * z_vals).sum(dim=-1), "weights_sum": weights_sum,
            "sdfs": geo.get("sdf"), "sigmas": sigmas, "sdf_gradients": sdf_gradients,
            # smooth normalisation: a background ray composites an exactly-zero normal
            "normal_image": _safe_normalize((w3 * normals.detach()).sum(dim=-2))}
