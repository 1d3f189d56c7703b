"""VolSDF error-bound sampling (the ``run_volsdf`` strategy).

Counterpart of ``envidr_tpu/render/volsdf.py``: the reference's ``while
not_converge`` refinement becomes a fixed unroll of ``grow_iters`` rounds,
each adding exactly ``num_steps`` samples, then the final
opacity-proportional draw; the per-ray beta of the error bound (Theorem 1 /
Lemma 2 of the VolSDF paper) is found by ``beta_iters`` steps of bisection.

The sampler takes no gradient: the JAX package stops it at every SDF query
and at the initial beta, so its samples are constants of the parameters.
It runs under ``torch.no_grad()`` and queries the SDF in chunks of rays of
at most ``QUERY_POINTS`` points (a round at full width queries 4096 rays x
2560 samples), which bounds its memory and does not change its result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from envidr_tpu_torch.geometry.rays import near_far_from_aabb
from envidr_tpu_torch.models.network import NeRFNetwork, _safe_normalize
from envidr_tpu_torch.ops.compositing import alphas_from_sigmas, weights_from_alphas
from envidr_tpu_torch.ops.density import laplace_beta, laplace_density
from envidr_tpu_torch.render.uniform import sample_pdf

QUERY_POINTS = 1 << 21          # points of one no-grad SDF query chunk


@dataclasses.dataclass(frozen=True)
class VolSDFOptions:
    num_steps: int = 128            # coarse + per-round eval samples
    upsample_steps: int = 64        # final importance samples
    n_samples_extra: int = 32
    grow_iters: int = 4             # the reference's max_total_iters=5: 4 grows + final
    beta_iters: int = 10
    eps: float = 0.1
    add_tiny: float = 1e-6
    min_near: float = 0.2
    density_scale: float = 1.0
    perturb: bool = False
    training: bool = False


def _d_star(z_vals: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """Distance bound d* of Theorem 1 (volsdf.py:112-125), [N, S-1]."""
    a = z_vals[:, 1:] - z_vals[:, :-1]
    b = sdf[:, :-1].abs()
    c = sdf[:, 1:].abs()
    first = a**2 + b**2 <= c**2
    second = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    d_mid = 2.0 * torch.sqrt(area) / torch.clamp(a, min=1e-12)
    zero = torch.zeros_like(a)
    ds = torch.where(first, b, torch.where(second, c, torch.where(b + c - a > 0, d_mid, zero)))
    return torch.where(torch.sign(sdf[:, 1:]) * torch.sign(sdf[:, :-1]) == 1, ds, zero)


def _error_bound(beta: torch.Tensor, sdf: torch.Tensor, dists: torch.Tensor,
                 d_star: torch.Tensor) -> torch.Tensor:
    """Each ray's largest opacity-error bound (volsdf.py:27-37); beta [N, 1]."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]), dists * density[:, :-1]], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    err = torch.exp(-d_star / beta) * dists**2 / (4.0 * beta**2)
    err_int = torch.cumsum(err, dim=-1)
    bound = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) * torch.exp(-integral[:, :-1])
    return bound.amax(dim=-1)


def _transmittance(free_energy: torch.Tensor) -> torch.Tensor:
    """exp(-(exclusive cumsum of ``free_energy``))."""
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]), free_energy[:, :-1]], dim=-1)
    return torch.exp(-torch.cumsum(shifted, dim=-1))


@torch.no_grad()
def volsdf_sample(net: NeRFNetwork, opts: VolSDFOptions, rays_o, rays_d, nears, fars,
                  aabb, *, level_mask=None, beta_min=None, beta_cap=None,
                  noise: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                  perm: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The sorted sample depths [N, upsample_steps + n_samples_extra + 2].

    ``beta_min`` / ``beta_cap`` (numbers or device tensors) replace the
    Laplace beta's floor and bound its cap, as the scene renderer's do.
    The draws of a training render are ``noise`` [N, num_steps] in [0, 1)
    (the jitter, under ``perturb``), ``u`` [N, upsample_steps] (the final
    draw) and ``perm`` (a permutation of the samples, whose first
    ``n_samples_extra`` are kept besides); each missing one is drawn from
    ``generator``.  Not training, all three are deterministic."""
    N, T, dev = rays_o.shape[0], opts.num_steps, rays_o.device
    z = torch.linspace(0.0, 1.0, T, device=dev)
    z_vals = nears[:, None] + (fars - nears)[:, None] * z[None, :]
    if opts.perturb:
        if noise is None:
            noise = torch.rand(z_vals.shape, generator=generator, device=dev)
        z_vals = z_vals + (noise - 0.5) * ((fars - nears)[:, None] / T)

    cfg = net.cfg
    beta0 = laplace_beta(net.sdf_density.beta, cfg.beta_min if beta_min is None else beta_min,
                         cfg.beta_max)
    if beta_cap is not None:
        beta0 = torch.minimum(beta0, torch.as_tensor(beta_cap, device=dev))
    dists0 = z_vals[:, 1:] - z_vals[:, :-1]
    beta = torch.sqrt((1.0 / (4.0 * math.log(opts.eps + 1.0))) * (dists0**2).sum(dim=-1))

    def query_sdf(zv):
        rays = max(1, QUERY_POINTS // zv.shape[1])
        out = []
        for s in range(0, N, rays):
            o, d = rays_o[s:s + rays, None, :], rays_d[s:s + rays, None, :]
            xyz = o + d * zv[s:s + rays, :, None]
            xyz = torch.clamp(xyz, aabb[:3], aabb[3:])
            out.append(net.forward_geometry(xyz, level_mask)["sdf"].float())
        return torch.cat(out)

    def last_inf(dists):
        return torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)

    for _ in range(opts.grow_iters):
        sdf = query_sdf(z_vals)
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        d_star = _d_star(z_vals, sdf)
        # beta bisection (volsdf.py:127-136)
        err0 = _error_bound(beta0.reshape(1, 1), sdf, dists, d_star)
        beta = torch.where(err0 <= opts.eps, beta0, beta)
        b_min, b_max = beta0.expand(N), beta
        for _ in range(opts.beta_iters):
            b_mid = 0.5 * (b_min + b_max)
            err = _error_bound(b_mid[:, None], sdf, dists, d_star)
            b_max = torch.where(err <= opts.eps, b_mid, b_max)
            b_min = torch.where(err > opts.eps, b_mid, b_min)
        beta = b_max
        # error-proportional upsampling weights (volsdf.py:151-158)
        dists_inf = last_inf(dists)
        transmittance = _transmittance(dists_inf * laplace_density(sdf, beta[:, None]))
        err = torch.exp(-d_star / beta[:, None]) * dists**2 / (4.0 * beta[:, None] ** 2)
        bound_op = ((torch.clamp(torch.exp(torch.cumsum(err, dim=-1)), max=1e6) - 1.0)
                    * transmittance[:, :-1])
        new_z = sample_pdf(z_vals, bound_op + opts.add_tiny, opts.num_steps, det=True)
        z_vals = torch.sort(torch.cat([z_vals, new_z], dim=-1), dim=-1).values

    # the final draw: in proportion to the opacity (volsdf.py:160-166)
    sdf = query_sdf(z_vals)
    free_energy = last_inf(z_vals[:, 1:] - z_vals[:, :-1]) * laplace_density(sdf, beta[:, None])
    w_final = (1.0 - torch.exp(-free_energy)) * _transmittance(free_energy)
    z_samples = sample_pdf(z_vals, w_final[:, :-1] + 1e-5, opts.upsample_steps,
                           det=not opts.training, generator=generator,
                           u=u if opts.training else None)

    # extra coverage samples (volsdf.py:268-277)
    z_extra = [nears[:, None], fars[:, None]]
    if opts.n_samples_extra > 0:
        S = z_vals.shape[1]
        if opts.training:
            if perm is None:
                perm = torch.randperm(S, generator=generator, device=dev)
            idx = perm[:opts.n_samples_extra]
        else:
            idx = torch.linspace(0, S - 1, opts.n_samples_extra, device=dev).long()
        z_extra.append(z_vals[:, idx])
    return torch.sort(torch.cat([z_samples] + z_extra, dim=-1), dim=-1).values


def volsdf_draws(opts: VolSDFOptions, n: int, generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """The draws of a training render of ``n`` rays, made from ``generator``
    in the order in which :func:`volsdf_sample` makes them: ``noise`` [n,
    num_steps] (under ``perturb``), ``u`` [n, upsample_steps] and ``perm`` of
    the ``num_steps * (grow_iters + 1)`` samples (when ``n_samples_extra``).
    A sharded step draws the global batch's and keeps its rays' rows."""
    draws = {}
    if opts.perturb:
        draws["noise"] = torch.rand((n, opts.num_steps), generator=generator, device=device)
    draws["u"] = torch.rand((n, opts.upsample_steps), generator=generator, device=device)
    if opts.n_samples_extra > 0:
        draws["perm"] = torch.randperm(opts.num_steps * (opts.grow_iters + 1),
                                       generator=generator, device=device)
    return draws


def render_volsdf(net: NeRFNetwork, opts: VolSDFOptions, rays_o, rays_d, bg_color,
                  aabb: torch.Tensor, *, env_index=0, level_mask=None, beta_min=None,
                  beta_cap=None, noise=None, u=None, perm=None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """``run_volsdf``: the error-bound samples (:func:`volsdf_sample`, whose
    draws ``noise``, ``u``, ``perm`` and ``generator`` give), then shading and
    compositing.  Rays that miss the aabb get the interval [2, 2.001] and no
    density; positions are clipped to the aabb; the last interval is 1e4."""
    cfg = net.cfg
    N = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, opts.min_near)
    miss = fars > 1e9
    nears = torch.where(miss, torch.full_like(nears, 2.0), nears)
    fars = torch.where(miss, torch.full_like(fars, 2.001), fars)
    z_vals = volsdf_sample(net, opts, rays_o, rays_d, nears, fars, aabb,
                           level_mask=level_mask, beta_min=beta_min, beta_cap=beta_cap,
                           noise=noise, u=u, perm=perm, generator=generator)
    xyz = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None],
                      aabb[:3], aabb[3:])
    dirs = rays_d[:, None, :].expand_as(xyz)
    geo, normals, sdf_gradients = net.geometry_with_normals(
        xyz, level_mask, create_graph=torch.is_grad_enabled())
    sigmas = opts.density_scale * net.sdf_to_sigma(geo["sdf"], beta_min=beta_min,
                                                   beta_cap=beta_cap)
    sigmas = torch.where(miss[:, None], torch.zeros((), device=sigmas.device), sigmas)
    roughness = geo["roughness"]
    if roughness is None:
        roughness = torch.full_like(sigmas[..., None], cfg.default_roughness)
    normals_enc, w_r_enc, n_dot_w_o, n_env_enc = net.get_color_mlp_extra_params(
        normals, dirs, roughness)
    rgbs, _ = net.forward_color(geo["geo_feat"], dirs, normals_enc, w_r_enc, n_dot_w_o,
                                env_index=env_index, n_env_enc=n_env_enc, roughness=roughness,
                                blend_weight=geo["blend_weight"])
    deltas = torch.diff(z_vals, dim=-1)
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e4)], dim=-1)
    weights = weights_from_alphas(alphas_from_sigmas(sigmas, deltas))
    weights_sum = weights.sum(dim=-1)
    if isinstance(bg_color, (int, float)):      # a fill: a copied number blocks the host
        bg = torch.full((N, 3), float(bg_color), dtype=rays_o.dtype, device=rays_o.device)
    else:
        bg = torch.as_tensor(bg_color, dtype=rays_o.dtype, device=rays_o.device).expand(N, 3)
    w3 = weights[..., None]
    return {"image": (w3 * rgbs).sum(dim=-2) + (1.0 - weights_sum[..., None]) * bg,
            "depth": (weights * z_vals).sum(dim=-1), "weights_sum": weights_sum,
            "sdfs": geo["sdf"], "sigmas": sigmas, "sdf_gradients": sdf_gradients,
            # smooth normalisation: a background ray composites an exactly-zero normal
            "normal_image": _safe_normalize((w3 * normals.detach()).sum(dim=-2))}
