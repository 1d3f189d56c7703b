"""Scene-mode training runtime: optimizer groups, train step, grid upkeep,
EMA, chunked eval render.

Counterpart of ``envidr_tpu/train/trainer.py`` (scene mode):

  * Adam(0.9, 0.99, eps=1e-15) with the parameter groups lr/plr/slr/elr,
    each group's gradient clipped to global norm 10, and the learning rate
    decayed by ``0.1 ** (step / iters)`` where ``step`` counts the updates
    applied (``trainer.py:82-108``), written out as :class:`Adam`;
  * a step whose gradients are not all finite leaves the parameters and
    every optimizer state as they were (``optax.apply_if_finite``) and is
    counted in :attr:`Trainer.notfinite` (``:105-108, :559-564``);
  * a per-step EMA of the parameters, decay 0.95 (``:543-546``), used by the
    eval render;
  * the occupancy grid refreshed every ``update_extra_interval`` steps, the
    first refresh before the first step (an empty grid gives no samples);
  * the sample budget K fixed per epoch from the running mean sample count
    (``sample_budget``, ``:314``).

A step does not block the host: the finite check, the counters and the
mean-count EMA stay on the device, and the host reads the EMA once, when an
epoch chooses its K.  Only the grid refresh may synchronise.

:meth:`Trainer.load_checkpoint` reads the JAX package's checkpoints (a
pickle of numpy arrays; nothing else is unpickled).

Error-map, patch and crop sampling, image batches, the indirect pass,
sphere mode and saving checkpoints are not ported yet and raise.
"""

from __future__ import annotations

import copy
import importlib
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.config import Options
from envidr_tpu_torch.geometry.rays import full_image_rays, sampled_rays, srgb_to_linear
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig
from envidr_tpu_torch.ops.grid import GridSpec, OccupancyGrid, init_grid, update_grid
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
        "frozen_mlps / train_renv / train_env_only":
            bool(opt.frozen_mlps) or opt.train_renv or opt.train_env_only,
        "color_mlp_path": bool(opt.color_mlp_path),
        "beta_cap_sched": bool(opt.beta_cap_sched),
        "color_net_start_iter > 1": opt.color_net_start_iter > 1,
    }
    return [name for name, bad in checks.items() if bad]


class Adam:
    """The optax chain of ``make_optimizer`` (``trainer.py:82-108``) for each
    parameter group: clip to global norm 10, Adam(b1 0.9, b2 0.99, eps 1e-15),
    scale by ``0.1 ** min(count / iters, 1)`` and by ``-lr``; the whole update
    applied only if every gradient is finite (``optax.apply_if_finite``).

    The finite flag, the moments and both counters stay on the device; each
    state takes ``torch.where(finite, new, old)``, so a skipped update leaves
    every tensor bit-equal.  A parameter without a gradient takes a zero one,
    as in optax.
    """

    B1, B2, EPS = 0.9, 0.99, 1e-15

    def __init__(self, net: NeRFNetwork, opt: Options, device: torch.device):
        base = {"net": opt.lr, "grid": opt.plr or opt.lr, "scalar": opt.slr or opt.lr,
                "env": opt.elr or opt.lr}
        params = {k: [] for k in base}
        for name, module in net.named_children():
            params[_GROUP_OF.get(name, "net")].extend(module.parameters())
        self.groups = [(base[k], ps) for k, ps in params.items() if ps]
        self.iters = opt.iters
        every = [p for _, ps in self.groups for p in ps]
        self.m = [torch.zeros_like(p) for p in every]
        self.v = [torch.zeros_like(p) for p in every]
        self.count = torch.zeros((), dtype=torch.int64, device=device)     # applied
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)   # not finite

    @torch.no_grad()
    def step(self):
        grads = [[p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
                 for _, ps in self.groups]
        finite = torch.stack([torch.isfinite(g).all() for gs in grads for g in gs]).all()
        count = self.count + 1
        bc1 = 1.0 - self.B1 ** count.float()
        bc2 = 1.0 - self.B2 ** count.float()
        decay = 0.1 ** torch.clamp(self.count.float() / self.iters, max=1.0)
        i = 0
        for (lr, ps), gs in zip(self.groups, grads):
            m, v = self.m[i:i + len(ps)], self.v[i:i + len(ps)]
            i += len(ps)
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
            gs = torch._foreach_mul(gs, torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm))
            m_new = torch._foreach_add(torch._foreach_mul(gs, 1.0 - self.B1),
                                       torch._foreach_mul(m, self.B1))
            v_new = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                          1.0 - self.B2),
                                       torch._foreach_mul(v, self.B2))
            den = torch._foreach_sqrt(torch._foreach_div(v_new, bc2))
            torch._foreach_add_(den, self.EPS)
            upd = torch._foreach_div(torch._foreach_div(m_new, bc1), den)
            torch._foreach_mul_(upd, decay)
            torch._foreach_mul_(upd, -lr)
            p_new = torch._foreach_add(ps, upd)
            for old, new in zip([*ps, *m, *v], [*p_new, *m_new, *v_new]):
                torch.where(finite, new, old, out=old)
        self.count += finite
        self.skipped += ~finite


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
        self.optimizer = Adam(self.net, opt, self.device)
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
        # running mean of samples per ray (< 0: none yet), f64 on the device
        # so that it equals the reference's host EMA in Python floats
        self.mean_count = torch.full((), -1.0, dtype=torch.float64, device=self.device)
        self._sched: Optional[StepSchedule] = None
        self._K = 0
        self._order: list = []
        self._images = None

    @property
    def applied_steps(self) -> torch.Tensor:
        """Updates applied (drives the lr decay), a device tensor."""
        return self.optimizer.count

    @property
    def notfinite(self) -> torch.Tensor:
        """Updates skipped for non-finite gradients, a device tensor."""
        return self.optimizer.skipped

    # ------------------------------------------------------------ grid

    def update_extra_state(self, full: bool = False):
        """Refresh the occupancy grid: whole-grid sweeps for the first 16
        updates (or ``full``), a rotating quarter slab afterwards."""
        lm = (level_mask(self._sched.enabled_levels, self.cfg.num_levels, self.device)
              if self._sched is not None else None)
        net = self.net

        def density_fn(x):    # NeuS: the alpha of one default step, no normals
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
        mean_count = float(self.mean_count)              # the epoch's one read
        est = cap if mean_count <= 0 else int(mean_count * 1.5) + 8
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
        mean_count = float(self.mean_count)
        if self.opt.samples_budget <= 0 and mean_count > 0:
            est = min(int(mean_count * 1.5) + 8, cap)
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

    def _refreshes_grid(self) -> bool:
        every = self._sched.update_extra_interval
        return every > 0 and self.global_step % every == 0

    def step_may_sync(self) -> bool:
        """Whether the next :meth:`train_step` may block the host: only the
        first step of an epoch (it reads the mean count to choose K) and a
        grid-refresh step do."""
        return not self._order or self._refreshes_grid()

    def forward_loss(self, rays_o, rays_d, gt_rgb, bg, alpha_mask, *, K: int,
                     sched: StepSchedule, noise: Optional[torch.Tensor] = None):
        """Render the rays with the live parameters and assemble the losses:
        -> (loss, render outputs, detached loss terms)."""
        opt, w = self.opt, sched.weights
        ropts = SceneRenderOptions(
            max_steps=sched.max_steps, num_samples=K,
            early_stop_steps=sched.early_stop_steps, dt_gamma=opt.dt_gamma,
            T_thresh=opt.T_thresh, min_near=opt.min_near, perturb=noise is not None,
            training=True, grid_size=self.grid_spec.grid_size,
            coarse_march=opt.coarse_march)
        neus = self.cfg.use_neus_sdf
        out = render_scene(
            self.net, ropts, self.grid.bitfield, rays_o, rays_d, bg, self.aabb,
            noise=noise,
            level_mask=level_mask(sched.enabled_levels, self.cfg.num_levels, self.device),
            normal_anneal_ratio=sched.normal_anneal_ratio,
            # the epoch's anneal, read afresh each step (nothing compiles it in)
            cos_anneal_ratio=sched.cos_anneal_ratio,
            beta_min=w["_beta_min"] if opt.beta_min_sched and not neus else None)
        neus_inv_s = (torch.clamp(torch.exp(self.net.sdf_density.variance * 10.0), 1e-6, 1e6)
                      if neus else None)
        loss, terms = compute_losses(out, gt_rgb, sched.flags, w, alpha_mask=alpha_mask,
                                     neus_inv_s=neus_inv_s)
        return loss, out, terms

    def _apply_update(self):
        """Skip-if-non-finite, per-group clip, decayed lr, Adam, EMA."""
        self.optimizer.step()
        for p in self.net.parameters():
            p.grad = None
        with torch.no_grad():
            torch._foreach_lerp_(list(self.ema_net.parameters()),
                                 list(self.net.parameters()), 1.0 - EMA_DECAY)

    def train_step(self, dataset, *, refresh_grid: bool = True) -> Dict[str, object]:
        """One step on the next image of the epoch's shuffled order: the loss,
        its terms, the step's mean sample count and ``notfinite`` as detached
        device tensors (nothing is read back), and the epoch's ``K``.
        ``refresh_grid=False`` skips the grid refresh that falls on this step
        (a benchmark times the steps alone, as ``bench.py`` does)."""
        idx = self._next_index(dataset)
        sched, opt = self._sched, self.opt
        if refresh_grid and self._refreshes_grid():
            self.update_extra_state()
        if self._images is None or self._images[0] is not dataset:
            self._images = (dataset, dataset.device_images(self.device),
                            torch.as_tensor(dataset.poses, device=self.device))
        _, images, poses = self._images
        pose = poses[idx][None]
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
        mc = out["counts"].float().mean()
        prev = torch.as_tensor(self.mean_count, dtype=torch.float64, device=self.device)
        self.mean_count = torch.where(prev < 0, mc.double(), 0.9 * prev + 0.1 * mc.double())
        self.global_step += 1
        return {**terms, "loss": loss.detach(), "mean_count": mc,
                "notfinite": self.notfinite.clone(), "K": self._K}

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
            grid_size=self.grid_spec.grid_size, coarse_march=opt.coarse_march)
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

    # ------------------------------------------------------ checkpoints

    def load_checkpoint(self, path: str):
        """Read a checkpoint of the JAX package (``Trainer.save_checkpoint``
        there): ``epoch``, ``global_step``, ``mean_count``, ``params``,
        ``ema`` and ``grid``.  The optimizer starts afresh."""
        with open(path, "rb") as f:
            payload = _ArrayUnpickler(f).load()
        self.epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.mean_count = torch.tensor(float(payload.get("mean_count", -1.0)),
                                       dtype=torch.float64, device=self.device)
        load_jax_params(self.net, payload["params"])
        load_jax_params(self.ema_net, payload["ema"])
        density, bitfield, mean_density, iter_density = payload["grid"]
        self.grid = OccupancyGrid(
            density=torch.from_numpy(np.asarray(density, np.float32)).to(self.device),
            bitfield=torch.from_numpy(np.asarray(bitfield, bool)).to(self.device),
            mean_density=torch.tensor(float(mean_density), device=self.device),
            iter_density=int(iter_density))
        self._sched, self._order = None, []
        return True


# the only globals a checkpoint may name: numpy's array reconstruction
# (numpy 2 pickles them under numpy._core, numpy 1 under numpy.core)
_CKPT_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("numpy.core.multiarray", "_reconstruct"),
                 ("numpy.core.multiarray", "scalar")}


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays in plain containers and refuses every other
    global, so a checkpoint cannot run code when it is read."""

    def find_class(self, module, name):
        canon = module.replace("numpy._core", "numpy.core", 1)
        if (canon, name) not in _CKPT_GLOBALS:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}, not a part of a numpy array")
        if canon == "numpy":
            return getattr(np, name)
        try:
            mod = importlib.import_module("numpy._core.multiarray")
        except ImportError:
            mod = importlib.import_module("numpy.core.multiarray")
        return getattr(mod, name)
