"""Scene-mode training runtime: optimizer groups, train step, grid upkeep,
EMA, chunked eval render.

Counterpart of ``envidr_tpu/train/trainer.py`` (scene mode):

  * Adam(0.9, 0.99, eps=1e-15) with the parameter groups lr/plr/slr/elr,
    each group's gradient clipped to global norm 10, and the learning rate
    decayed by ``0.1 ** (step / iters)`` where ``step`` counts the updates
    applied (``trainer.py:82-108``);
  * a step whose gradients are not all finite is skipped and counted in
    :attr:`Trainer.notfinite` (``:105-108, :559-564``);
  * a per-step EMA of the parameters, decay 0.95 (``:543-546``), used by the
    eval render;
  * the occupancy grid refreshed every ``update_extra_interval`` steps, the
    first refresh before the first step (an empty grid gives no samples);
  * the sample budget K fixed per epoch from the running mean sample count
    (``sample_budget``, ``:314``).

Error-map, patch and crop sampling, image batches, the indirect pass,
sphere mode and checkpoints are not ported yet and raise.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.config import Options
from envidr_tpu_torch.geometry.rays import full_image_rays, sampled_rays, srgb_to_linear
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig
from envidr_tpu_torch.ops.grid import GridSpec, init_grid, update_grid
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train.losses import compute_losses
from envidr_tpu_torch.train.schedules import StepSchedule, level_mask, resolve

# parameter group of each top-level module (network.py:772-819); the rest is "net"
_GROUP_OF = {"encoder": "grid", "sdf_density": "scalar", "env_net": "env"}
CLIP_NORM = 10.0
EMA_DECAY = 0.95


def _unported(opt: Options):
    checks = {
        "error_map": opt.error_map,
        "patch_size > 1": opt.patch_size > 1,
        "center_crop": opt.center_crop > 0,
        "image_batch > 1": opt.image_batch > 1,
        "indir_ref": opt.indir_ref or opt.indir_ref_start_iter > 0,
        "env_sph_mode / render_env_on_sphere": opt.env_sph_mode or opt.render_env_on_sphere,
        "error_bound_sample": opt.error_bound_sample or opt.error_bound_start_iter > 0,
        "stratified_sampling": opt.stratified_sampling,
        "coarse_march": opt.coarse_march,
        "frozen_mlps / train_renv / train_env_only":
            bool(opt.frozen_mlps) or opt.train_renv or opt.train_env_only,
        "color_mlp_path": bool(opt.color_mlp_path),
        "beta_cap_sched": bool(opt.beta_cap_sched),
        "color_net_start_iter > 1": opt.color_net_start_iter > 1,
    }
    return [name for name, bad in checks.items() if bad]


def make_optimizer(net: NeRFNetwork, opt: Options) -> torch.optim.Adam:
    base = {"net": opt.lr, "grid": opt.plr or opt.lr, "scalar": opt.slr or opt.lr,
            "env": opt.elr or opt.lr}
    params = {k: [] for k in base}
    for name, module in net.named_children():
        params[_GROUP_OF.get(name, "net")].extend(module.parameters())
    groups = [{"params": ps, "lr": base[k], "base_lr": base[k], "name": k}
              for k, ps in params.items() if ps]
    return torch.optim.Adam(groups, betas=(0.9, 0.99), eps=1e-15)


class Trainer:
    def __init__(self, opt: Options, cfg: NetworkConfig, *, device=None,
                 seed: Optional[int] = None, net: Optional[NeRFNetwork] = None):
        missing = _unported(opt)
        if missing:
            raise NotImplementedError(
                f"not ported to envidr_tpu_torch yet: {', '.join(missing)}")
        self.opt, self.cfg = opt, cfg
        self.device = resolve_device(device)
        seed = opt.seed if seed is None else seed
        if net is None:
            net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)
        self.ema_net = copy.deepcopy(self.net).requires_grad_(False)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.optimizer = make_optimizer(self.net, opt)
        self.grid_spec = GridSpec(grid_size=128, bound=cfg.bound,
                                  density_thresh=opt.density_thresh, density_scale=1.0)
        self.grid = init_grid(self.grid_spec, self.device)
        if len(opt.marching_aabb) == 6:
            aabb = torch.tensor(opt.marching_aabb) * opt.scale
            self.aabb = aabb.clamp(-cfg.bound, cfg.bound).to(self.device)
        else:
            self.aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                                     device=self.device)
        self.eval_aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3,
                                      device=self.device)
        self.epoch = 0
        self.global_step = 0
        self.applied_steps = 0        # updates applied (drives the lr decay)
        self.notfinite = 0            # updates skipped for non-finite gradients
        self.mean_count = -1.0
        self._sched: Optional[StepSchedule] = None
        self._K = 0
        self._order: list = []
        self._images = None

    # ------------------------------------------------------------ grid

    def update_extra_state(self, full: bool = False):
        """Refresh the occupancy grid: whole-grid sweeps for the first 16
        updates (or ``full``), a rotating quarter slab afterwards."""
        lm = (level_mask(self._sched.enabled_levels, self.cfg.num_levels, self.device)
              if self._sched is not None else None)
        net = self.net

        def density_fn(x):
            return net.sdf_to_sigma(net.forward_geometry(x, lm)["sdf"])

        fraction = 1 if (full or self.grid.iter_density < 16) else 4
        with torch.no_grad():
            self.grid = update_grid(self.grid, self.grid_spec, density_fn,
                                    self.generator, fraction=fraction)

    # ---------------------------------------------------------- budgets

    def sample_budget(self, sched: StepSchedule) -> int:
        """Per-ray sample budget K from the running mean sample count."""
        if self.opt.samples_budget > 0:
            return self.opt.samples_budget
        cap = sched.early_stop_steps if sched.early_stop_steps > 0 \
            else min(sched.max_steps, 1024)
        est = cap if self.mean_count <= 0 else int(self.mean_count * 1.5) + 8
        # floor: a hard-pruned grid must not starve the thin surface shell
        floor = min(max(16, self.opt.min_samples_budget), max(cap, 16))
        k = floor
        while k < min(est, cap):
            k *= 2
        return int(min(k, max(cap, floor), 1024))

    def eval_samples_budget(self) -> int:
        K = self.opt.eval_samples_budget
        sched = self._sched
        ess = sched.early_stop_steps if sched else self.opt.early_stop_steps
        ms = sched.max_steps if sched else self.opt.max_steps
        cap = ess if ess > 0 else min(ms, 1024)
        K = min(K, max(cap, 16))
        if self.opt.samples_budget <= 0 and self.mean_count > 0:
            est = min(int(self.mean_count * 1.5) + 8, cap)
            k = max(16, self.opt.min_samples_budget)
            while k < est:
                k *= 2
            K = min(K, k)
        return int(K)

    # ------------------------------------------------------------ step

    def _next_index(self, dataset) -> int:
        if not self._order:
            self.epoch += 1
            self._sched = resolve(self.opt, self.epoch, self.global_step)
            self._K = self.sample_budget(self._sched)
            rng = np.random.default_rng(self.opt.seed * 100003 + self.epoch)
            self._order = list(dataset.epoch_order(rng))
        return int(self._order.pop(0))

    def forward_loss(self, rays_o, rays_d, gt_rgb, bg, alpha_mask, *, K: int,
                     sched: StepSchedule, noise: Optional[torch.Tensor] = None):
        """Render the rays with the live parameters and assemble the losses:
        -> (loss, render outputs, detached loss terms)."""
        opt, w = self.opt, sched.weights
        ropts = SceneRenderOptions(
            max_steps=sched.max_steps, num_samples=K,
            early_stop_steps=sched.early_stop_steps, dt_gamma=opt.dt_gamma,
            T_thresh=opt.T_thresh, min_near=opt.min_near, perturb=noise is not None,
            training=True, grid_size=self.grid_spec.grid_size)
        out = render_scene(
            self.net, ropts, self.grid.bitfield, rays_o, rays_d, bg, self.aabb,
            noise=noise,
            level_mask=level_mask(sched.enabled_levels, self.cfg.num_levels, self.device),
            normal_anneal_ratio=sched.normal_anneal_ratio,
            beta_min=w["_beta_min"] if opt.beta_min_sched else None)
        loss, terms = compute_losses(out, gt_rgb, sched.flags, w, alpha_mask=alpha_mask)
        return loss, out, terms

    def _apply_update(self):
        """Skip-if-non-finite, per-group clip, decayed lr, Adam, EMA."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        finite = bool(torch.stack([torch.isfinite(p.grad).all() for p in params]).all())
        if finite:
            decay = 0.1 ** min(self.applied_steps / self.opt.iters, 1.0)
            for group in self.optimizer.param_groups:
                grads = [p.grad for p in group["params"] if p.grad is not None]
                if grads:
                    norm = torch.linalg.vector_norm(
                        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                    factor = torch.where(norm < CLIP_NORM, torch.ones_like(norm),
                                         CLIP_NORM / norm)
                    torch._foreach_mul_(grads, factor)
                group["lr"] = group["base_lr"] * decay
            self.optimizer.step()
            self.applied_steps += 1
        else:
            self.notfinite += 1
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for e, p in zip(self.ema_net.parameters(), self.net.parameters()):
                e.lerp_(p, 1.0 - EMA_DECAY)

    def train_step(self, dataset) -> Dict[str, float]:
        """One step on the next image of the epoch's shuffled order."""
        idx = self._next_index(dataset)
        sched, opt = self._sched, self.opt
        if (sched.update_extra_interval > 0
                and self.global_step % sched.update_extra_interval == 0):
            self.update_extra_state()
        if self._images is None or self._images[0] is not dataset:
            self._images = (dataset, dataset.device_images(self.device))
        images = self._images[1]
        pose = torch.as_tensor(dataset.poses[idx], device=self.device)[None]
        rays = sampled_rays(self.generator, pose, dataset.intrinsics, dataset.H,
                            dataset.W, sched.num_rays)
        rays_o, rays_d, inds = rays["rays_o"][0], rays["rays_d"][0], rays["inds"][0]
        pix = images[idx][inds].float() / 255.0
        if opt.color_space == "linear":
            pix = torch.cat([srgb_to_linear(pix[..., :3]), pix[..., 3:]], dim=-1)
        n = pix.shape[0]
        if dataset.C == 4:
            if opt.alpha_bg_mode == "white":
                bg = torch.ones((n, 3), device=self.device)
            else:
                bg = torch.rand((n, 3), generator=self.generator, device=self.device)
            gt_rgb = pix[..., :3] * pix[..., 3:] + bg * (1.0 - pix[..., 3:])
            alpha_mask = pix[..., 3]
        else:
            bg = torch.ones((n, 3), device=self.device)
            gt_rgb, alpha_mask = pix[..., :3], None
        noise = torch.rand((n,), generator=self.generator, device=self.device)

        loss, out, terms = self.forward_loss(rays_o, rays_d, gt_rgb, bg, alpha_mask,
                                             K=self._K, sched=sched, noise=noise)
        loss.backward()
        self._apply_update()
        mc = float(out["counts"].float().mean())
        self.mean_count = mc if self.mean_count < 0 else 0.9 * self.mean_count + 0.1 * mc
        self.global_step += 1
        metrics = {k: float(v) for k, v in terms.items()}
        metrics.update(loss=float(loss.detach()), mean_count=mc, notfinite=self.notfinite,
                       K=self._K)
        return metrics

    # ------------------------------------------------------------ eval

    def render_image(self, pose, intrinsics, H: int, W: int, *, use_ema: bool = True,
                     bg_color: float = 1.0) -> Dict[str, np.ndarray]:
        """Render a whole image in chunks of ``eval_ray_chunk`` rays."""
        net = self.ema_net if use_ema else self.net
        opt = self.opt
        ropts = SceneRenderOptions(
            max_steps=opt.max_steps, num_samples=self.eval_samples_budget(),
            early_stop_steps=opt.early_stop_steps, dt_gamma=opt.dt_gamma,
            T_thresh=opt.T_thresh, min_near=opt.min_near,
            grid_size=self.grid_spec.grid_size)
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        rays_o, rays_d = full_image_rays(pose[None], intrinsics, H, W)
        rays_o, rays_d = rays_o[0], rays_d[0]
        chunk = opt.eval_ray_chunk or 4096
        keep = ("image", "depth", "weights_sum", "normal_image", "diffuse_image",
                "specular_image", "roughness_image")
        parts: Dict[str, list] = {}
        with torch.no_grad():
            for s in range(0, rays_o.shape[0], chunk):
                res = render_scene(net, ropts, self.grid.bitfield, rays_o[s:s + chunk],
                                   rays_d[s:s + chunk], bg_color, self.eval_aabb)
                for k in keep:
                    if k in res:
                        parts.setdefault(k, []).append(res[k])
        return {k: torch.cat(v).reshape((H, W) + v[0].shape[1:]).cpu().numpy()
                for k, v in parts.items()}
