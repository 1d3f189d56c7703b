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
    (``sample_budget``, ``:314``);
  * the rendering MLPs of a pretrain loaded before the EMA copy is taken
    (``color_mlp_path`` / ``resume_mlps``, ``:129-131, :163-214``) and frozen
    (``frozen_mlps``: no update, no moments, no share of a clip norm, but
    their gradients enter the finite check, ``:54-108``);
  * relighting by swapping the env net (:meth:`Trainer.swap_env_net`);
  * the per-epoch projection of the Laplace beta under ``beta_cap_sched``
    and the cap handed to the render and the loss as a device tensor
    (``:389-390, :517-518, :585-593``);
  * the geometric cue, an SDF pre-fit to a sphere
    (:meth:`Trainer.train_geometric_cue`, ``:265-300``).

A step does not block the host: the finite check, the counters and the
mean-count EMA stay on the device, and the host reads the EMA once, when an
epoch chooses its K.  Only the grid refresh may synchronise.

:meth:`Trainer.load_checkpoint` reads the JAX package's checkpoints (a
pickle of numpy arrays; nothing else is unpickled).

Error-map, patch and crop sampling, image batches, the indirect pass,
sphere mode, the renv pretrain (``train_renv``, ``train_env_only``,
``resume_mlps`` ``all`` and ``renv``) and saving checkpoints are not ported
yet and raise.
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
from envidr_tpu_torch.io import torch_import
from envidr_tpu_torch.io.jax_params import load_jax_params, merge_mlp, mlp_from_tree
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig
from envidr_tpu_torch.ops import density as density_ops
from envidr_tpu_torch.ops.grid import GridSpec, OccupancyGrid, init_grid, update_grid
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train.losses import compute_losses
from envidr_tpu_torch.train.schedules import StepSchedule, level_mask, resolve

# parameter group of each top-level module (network.py:772-819); the rest is "net"
_GROUP_OF = {"encoder": "grid", "sdf_density": "scalar", "env_net": "env"}
# frozen_mlps / resume_mlps names -> modules (trainer.py:73-78, 182-184)
MLP_NAMES = {"specular": "color_net", "diffuse": "diffuse_net", "specular_env": "env_net"}
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
        "train_renv / train_env_only": opt.train_renv or opt.train_env_only,
        "color_net_start_iter > 1": opt.color_net_start_iter > 1,
    }
    return [name for name, bad in checks.items() if bad]


def frozen_modules(opt: Options) -> frozenset:
    """Top-level modules that ``frozen_mlps`` freezes (``_param_labels``)."""
    return frozenset(MLP_NAMES[n] for n in ("specular", "diffuse") if n in opt.frozen_mlps)


class Adam:
    """The optax chain of ``make_optimizer`` (``trainer.py:82-108``) for each
    parameter group: clip to global norm 10, Adam(b1 0.9, b2 0.99, eps 1e-15),
    scale by ``0.1 ** min(count / iters, 1)`` and by ``-lr``; the whole update
    applied only if every gradient is finite (``optax.apply_if_finite``).

    The modules of ``frozen`` form optax's ``set_to_zero`` group: no update,
    no moments, no part in a clip norm; but ``apply_if_finite`` wraps the
    whole ``multi_transform``, so their gradients enter the finite check.

    The finite flag, the moments and both counters stay on the device; each
    state takes ``torch.where(finite, new, old)``, so a skipped update leaves
    every tensor bit-equal.  A parameter without a gradient takes a zero one,
    as in optax.
    """

    B1, B2, EPS = 0.9, 0.99, 1e-15

    def __init__(self, net: NeRFNetwork, opt: Options, device: torch.device,
                 frozen: frozenset = frozenset()):
        self.base = {"net": opt.lr, "grid": opt.plr or opt.lr, "scalar": opt.slr or opt.lr,
                     "env": opt.elr or opt.lr}
        self.frozen_names = frozen
        self.iters = opt.iters
        self.m, self.v = [], []
        self.bind(net)
        self.count = torch.zeros((), dtype=torch.int64, device=device)     # applied
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)   # not finite

    def bind(self, net: NeRFNetwork):
        """Read the groups of ``net``'s parameters.  After a module swap a
        parameter that is still there keeps its moments; a new one starts
        with zero moments."""
        old = {id(p): mv for p, mv in zip(getattr(self, "params", []), zip(self.m, self.v))}
        params = {k: [] for k in self.base}
        self.frozen = []
        for name, module in net.named_children():
            dst = (self.frozen if name in self.frozen_names
                   else params[_GROUP_OF.get(name, "net")])
            dst.extend(module.parameters())
        self.groups = [(self.base[k], ps) for k, ps in params.items() if ps]
        self.params = [p for _, ps in self.groups for p in ps]
        mv = [old.get(id(p)) or (torch.zeros_like(p), torch.zeros_like(p)) for p in self.params]
        self.m, self.v = [m for m, _ in mv], [v for _, v in mv]

    @torch.no_grad()
    def step(self):
        grads = [[p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
                 for _, ps in self.groups]
        checked = [g for gs in grads for g in gs] + [p.grad for p in self.frozen
                                                     if p.grad is not None]
        finite = torch.stack([torch.isfinite(g).all() for g in checked]).all()
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
        if opt.color_mlp_path:        # before the EMA copy, as trainer.py:129-141
            self.resume_mlps(opt.color_mlp_path, opt.resume_mlps)
        self.ema_net = copy.deepcopy(self.net).requires_grad_(False)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.optimizer = Adam(self.net, opt, self.device, frozen_modules(opt))
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

    # ------------------------------------------- pretrained MLPs, relighting

    def resume_mlps(self, path: str, which):
        """Load the MLPs ``which`` names (``specular``, ``diffuse``,
        ``specular_env``) from a JAX checkpoint (``.ckpt``: its ``ema`` if it
        has one, else ``params``) or a reference ``.pth``, merged as
        ``Trainer._resume_mlps`` merges them (:func:`merge_mlp`).  A name the
        port cannot load raises; a module the file lacks raises."""
        if path.endswith(".ckpt"):
            payload = read_checkpoint(path)
            loaded = payload["ema"] if "ema" in payload else payload["params"]
        else:
            loaded = torch_import.network_params_from_state(torch_import.load_state_dict(path))
        for w in which:
            if w not in MLP_NAMES:
                raise NotImplementedError(
                    f"resume_mlps={w!r}: not ported to envidr_tpu_torch yet "
                    f"(the port loads {sorted(MLP_NAMES)})")
            name = MLP_NAMES[w]
            if name not in loaded or not hasattr(self.net, name):
                raise ValueError(f"resume_mlps={w!r}: {path} or the network has no {name}")
            setattr(self.net, name, merge_mlp(getattr(self.net, name), loaded[name]))

    def swap_env_net(self, path: str, split_diffuse: bool = False):
        """Relighting (``trainer.py:216-229``): the env net of ``path`` (an
        ``env_net_{i}.pth``) replaces ``env_net`` in the net and in the EMA
        net.  Where its widths equal the current ones the weights are copied
        in place and the optimizer keeps its moments, as the JAX trainer keeps
        its state; otherwise both modules are replaced and the new env net's
        moments start at zero."""
        if split_diffuse:
            raise NotImplementedError(
                "swap_env_net(split_diffuse=True) needs split_diffuse_env, "
                "not ported to envidr_tpu_torch yet")
        layers = torch_import.load_env_net(path)
        for net in (self.net, self.ema_net):
            old = net.env_net
            same = len(old) == len(layers) and all(
                tuple(l.weight.shape) == p["w"].shape[::-1] and (l.bias is None) == ("b" not in p)
                for l, p in zip(old, layers))
            if same:
                with torch.no_grad():
                    for l, p in zip(old, layers):
                        l.weight.copy_(torch.from_numpy(np.ascontiguousarray(p["w"].T)))
                        if l.bias is not None:
                            l.bias.copy_(torch.from_numpy(p["b"]))
            else:
                net.env_net = mlp_from_tree(layers).to(self.device)
        self.ema_net.env_net.requires_grad_(False)
        self.optimizer.bind(self.net)

    # ------------------------------------------------------------ grid

    def update_extra_state(self, full: bool = False):
        """Refresh the occupancy grid: whole-grid sweeps for the first 16
        updates (or ``full``), a rotating quarter slab afterwards."""
        lm = (level_mask(self._sched.enabled_levels, self.cfg.num_levels, self.device)
              if self._sched is not None else None)
        net = self.net

        def density_fn(x):    # NeuS: the alpha of one default step, no normals
            geo = net.forward_geometry(x, lm)
            return net.sdf_to_sigma(geo["sdf"]) if self.cfg.use_sdf else geo["sigma"]

        fraction = 1 if (full or self.grid.iter_density < 16) else 4
        with torch.no_grad():
            self.grid = update_grid(self.grid, self.grid_spec, density_fn,
                                    self.generator, fraction=fraction)

    def train_geometric_cue(self, steps: int = 500, points: int = 131072,
                            radius: Optional[float] = None, *, given_points=None):
        """Pre-fit the SDF to a sphere of radius ``bound * scale``
        (``trainer.py:265-300``): ``steps`` updates of the main optimizer
        (its moments and counters, as in JAX) on ``mean((sdf - (|x| - r))^2)``
        over ``points`` points drawn uniformly in ``[-bound, bound]^3`` from
        the trainer's generator, or over ``given_points[i]`` at step ``i``.
        The EMA is then set to the cued parameters.  Returns every step's
        loss, read on the host once, at the end (None for a density field)."""
        if not self.cfg.use_sdf:
            return None
        r = radius if radius is not None else self.cfg.bound * self.opt.scale
        b = self.cfg.bound
        losses = []
        for i in range(steps):
            if given_points is not None:
                pts = torch.as_tensor(given_points[i], device=self.device)
            else:
                pts = torch.rand((points, 3), generator=self.generator,
                                 device=self.device) * (2.0 * b) - b
            sdf = self.net.forward_geometry(pts)["sdf"]
            loss = ((sdf - (torch.linalg.vector_norm(pts, dim=-1) - r)) ** 2).mean()
            loss.backward()
            self.optimizer.step()
            for p in self.net.parameters():
                p.grad = None
            losses.append(loss.detach())
        self.ema_net.load_state_dict(self.net.state_dict())
        return torch.stack(losses).tolist()

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
            if self._beta_capped():
                # project the learned Laplace beta under the epoch's cap
                # (trainer.py:585-593); no host sync
                with torch.no_grad():
                    self.net.sdf_density.beta.clamp_(max=self._sched.weights["_beta_cap"])
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

    def _beta_capped(self) -> bool:
        cfg = self.cfg
        return bool(self.opt.beta_cap_sched) and cfg.use_sdf and not cfg.use_neus_sdf

    def forward_loss(self, rays_o, rays_d, gt_rgb, bg, alpha_mask, *, K: int,
                     sched: StepSchedule, noise: Optional[torch.Tensor] = None,
                     strat_noise: Optional[torch.Tensor] = None):
        """Render the rays with the live parameters and assemble the losses:
        -> (loss, render outputs, detached loss terms).  ``noise`` [N]
        perturbs the march, ``strat_noise`` [N, K] in [0, 1) jitters the
        samples (``stratified_sampling``)."""
        opt, w, flags, cfg = self.opt, sched.weights, sched.flags, self.cfg
        ropts = SceneRenderOptions(
            max_steps=sched.max_steps, num_samples=K,
            early_stop_steps=sched.early_stop_steps, dt_gamma=opt.dt_gamma,
            T_thresh=opt.T_thresh, min_near=opt.min_near, perturb=noise is not None,
            training=True, grid_size=self.grid_spec.grid_size,
            coarse_march=opt.coarse_march, stratified_sampling=opt.stratified_sampling,
            with_loss_aux=(flags.use_relsdf_loss or flags.use_backsdf_loss
                           or flags.use_orientation_loss or flags.use_dist_bound
                           or flags.use_entropy_loss))
        laplace = cfg.use_sdf and not cfg.use_neus_sdf
        # the epoch's cap as a device tensor (a fill, no host-to-device copy)
        beta_cap = (torch.full((), w["_beta_cap"], device=self.device)
                    if self._beta_capped() else None)
        out = render_scene(
            self.net, ropts, self.grid.bitfield, rays_o, rays_d, bg, self.aabb,
            noise=noise, strat_noise=strat_noise,
            level_mask=level_mask(sched.enabled_levels, cfg.num_levels, self.device),
            normal_anneal_ratio=sched.normal_anneal_ratio,
            # the epoch's anneal, read afresh each step (nothing compiles it in)
            cos_anneal_ratio=sched.cos_anneal_ratio, beta_cap=beta_cap,
            beta_min=w["_beta_min"] if opt.beta_min_sched and laplace else None)
        beta = neus_inv_s = None
        if laplace:          # the loss-side beta (trainer.py:515-518)
            beta = density_ops.laplace_beta(self.net.sdf_density.beta, w["_beta_min"],
                                            cfg.beta_max)
            if beta_cap is not None:
                beta = torch.minimum(beta, beta_cap)
        elif cfg.use_sdf:
            neus_inv_s = torch.clamp(torch.exp(self.net.sdf_density.variance * 10.0),
                                     1e-6, 1e6)
        loss, terms = compute_losses(out, gt_rgb, flags, w, alpha_mask=alpha_mask, beta=beta,
                                     neus_inv_s=neus_inv_s, roughness=out.get("roughness"))
        return loss, out, terms

    def _apply_update(self):
        """Skip-if-non-finite, per-group clip, decayed lr, Adam, EMA (of the
        trainable parameters: a frozen one stays equal to its EMA copy)."""
        self.optimizer.step()
        for p in self.net.parameters():
            p.grad = None
        frozen = self.optimizer.frozen_names
        pairs = [(e, p) for (name, p), e in zip(self.net.named_parameters(),
                                                self.ema_net.parameters())
                 if name.split(".", 1)[0] not in frozen]
        with torch.no_grad():
            torch._foreach_lerp_([e for e, _ in pairs], [p for _, p in pairs],
                                 1.0 - EMA_DECAY)

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
        noise = strat_noise = None
        if opt.stratified_sampling:     # jitter the samples, not the march
            strat_noise = torch.rand((n, self._K), generator=self.generator, device=self.device)
        else:
            noise = torch.rand((n,), generator=self.generator, device=self.device)

        loss, out, terms = self.forward_loss(rays_o, rays_d, gt_rgb, bg, alpha_mask,
                                             K=self._K, sched=sched, noise=noise,
                                             strat_noise=strat_noise)
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
        payload = read_checkpoint(path)
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


def read_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX package, read by :class:`_ArrayUnpickler`."""
    with open(path, "rb") as f:
        return _ArrayUnpickler(f).load()


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
