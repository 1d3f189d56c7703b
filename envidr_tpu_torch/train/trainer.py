"""Training runtime: optimizer groups, train step, grid upkeep, EMA,
chunked eval render.

Counterpart of ``envidr_tpu/train/trainer.py``, in scene mode (an occupancy
grid and a march) and in sphere mode (``env_sph_mode``: the neural-renderer
pretrain on the env-sphere set, ``render/sphere.py``; no grid):

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
  * relighting by swapping the env net (:meth:`Trainer.swap_env_net`; with
    ``split_diffuse`` the old env net becomes the diffuse env net);
  * the per-epoch projection of the Laplace beta under ``beta_cap_sched``
    and the cap handed to the render and the loss as a device tensor
    (``:389-390, :517-518, :585-593``);
  * the geometric cue, an SDF pre-fit to a sphere
    (:meth:`Trainer.train_geometric_cue`, ``:265-300``);
  * the ray samplers (``:397-423``): error-map sampling and its per-step
    EMA (``:547-555``), square patches (``patch_size``), a centre-weighted
    crop (``center_crop``), and image batches (``image_batch``: the rays
    split across B views; the epoch's order grouped B views at a time, the
    last group wrap-padded, ``:607-619``);
  * VolSDF's error-bound sampling in place of the march
    (``error_bound_sample`` / ``error_bound_start_iter``, ``:488-498``);
  * the background net behind the rays (``bg_radius > 0``; an RGBA image's
    alpha then stays out of the target, ``:456``);
  * the interreflection pass (``indir_ref``): the train step and the eval
    render go through the three-pass render of ``render/indirect.py``
    (``:469-490, :760-794``);
  * cells no training camera sees marked untrained
    (:meth:`Trainer.mark_untrained_grid`, ``:306-310``);
  * the epoch loop (:meth:`Trainer.train_one_epoch`, ``:580-680``), which
    reads its steps' metrics back once, at the epoch's end, and the ad-hoc
    steps of the viewer (:meth:`Trainer.train_one_epoch_steps`, ``:949-990``);
  * :meth:`Trainer.evaluate` (PSNR, SSIM and LPIPS over a split, an
    env-rotation sweep and image dumps, ``:817-932``);
  * env rotation in the eval render (``env_rot_radian``, ``:683-713``);
  * the diffuse term alone before ``color_net_start_iter`` (``:337-338``);
  * sphere mode (``env_sph_mode``, and ``render_env_on_sphere``, whose
    network has one env net and takes the same material inputs; no grid):
    each step conditioned on its frame's material and env
    index, read from one device tensor of the dataset, and, with
    ``train_renv``, on its mirror-sphere image; ``train_renv`` trains
    ``renv_net`` alone and ``train_env_only`` the env nets alone
    (``:54-76``); the eval render takes each view's material and env index
    (``overwrite_materials``, ``set_env_net_index``; ``:684-713, 817-866``).

A step does not block the host: the finite check, the counters and the
mean-count EMA stay on the device, and the host reads the EMA once, when an
epoch chooses its K.  Only the grid refresh may synchronise.  A sphere-mode
step has neither, and never synchronises.  An epoch of
:meth:`Trainer.train_one_epoch` adds one read, of its averaged metrics.

:meth:`Trainer.load_checkpoint` reads the JAX package's checkpoints (a
pickle of numpy arrays and optax's state tuples, read through an allow-list
of stand-ins; nothing else is unpickled) and resumes as the JAX trainer does
(``:1048-1103``): with the file's optimizer state, or else with the lr
schedule re-timed to the restored step; ``latest`` and ``best`` name the
workspace's own checkpoints.  :meth:`Trainer.save_checkpoint`
writes the JAX package's keys as plain numpy pytrees, which its
``load_checkpoint`` reads, and the port's optimizer state under a key of its
own (``torch_optimizer``).

A VolSDF step has no march and so no sample count: it leaves the running
mean count as it was.  The JAX step raises there (``KeyError: 'counts'``,
``trainer.py:558``).

Over a process group (``mesh``, :mod:`envidr_tpu_torch.parallel.mesh`) the
step is ray-data-parallel and equals the one-rank step on the same global
batch (``trainer.py:115-147, 425-443, 740-760``): the draws, the loss's
sums, the gradients, the sample count and the error map are global; the
grid is rank 0's; an eval render is shared out and all-gathered; rank 0
alone writes checkpoints.
"""

from __future__ import annotations

import collections
import copy
import importlib
import os
import pickle
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from envidr_tpu_torch import obs, resolve_device
from envidr_tpu_torch.config import Options
from envidr_tpu_torch.data.png import pixel_max, write_png
from envidr_tpu_torch.geometry.rays import (
    center_crop_rays, error_map_rays, full_image_rays, linear_to_srgb, patch_rays,
    sampled_rays, srgb_to_linear,
)
from envidr_tpu_torch.io import torch_import
from envidr_tpu_torch.io.jax_params import (
    load_jax_params, merge_mlp, merge_module, mlp_from_tree, module_arrays, module_tree,
    network_tree,
)
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig
from envidr_tpu_torch.ops import density as density_ops
from envidr_tpu_torch.ops.grid import (
    GridSpec, OccupancyGrid, init_grid, mark_untrained, update_grid,
)
from envidr_tpu_torch.parallel.mesh import (
    Group, all_reduce_grads, global_from_local, ray_sharded, replicate_tree, shard_rays,
)
from envidr_tpu_torch.render.indirect import IndirectOptions, render_scene_indirect
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.render.sphere import SphereRenderOptions, render_sphere
from envidr_tpu_torch.render.volsdf import VolSDFOptions, render_volsdf, volsdf_draws
from envidr_tpu_torch.train.losses import RayReduce, compute_losses
from envidr_tpu_torch.train.metrics import LPIPSMeter, PSNRMeter, SSIMMeter
from envidr_tpu_torch.train.schedules import StepSchedule, level_mask, resolve

VISUALS = (("diffuse_image", "diffuse"), ("specular_image", "specular"),
           ("roughness_image", "roughness"))

# parameter group of each top-level module (network.py:772-819); the rest is "net"
_GROUP_OF = {"encoder": "grid", "sdf_density": "scalar", "env_net": "env", "env_nets": "env",
             "diffuse_env_net": "env"}
# frozen_mlps / resume_mlps names -> modules (trainer.py:73-78, 185-189)
MLP_NAMES = {"specular": "color_net", "diffuse": "diffuse_net", "renv": "renv_net",
             "diffuse_env": "diffuse_env_net", "specular_env": "env_net"}
CLIP_NORM = 10.0
EMA_DECAY = 0.95
ERROR_MAP_CELLS = 128 * 128
SPHERE_STEPS, SPHERE_STEP_SIZE = 12, 0.002       # the sphere shell (trainer.py:362-368)
ENV_MODULES = ("env_net", "env_nets", "renv_net")


def frozen_modules(opt: Options, names=()) -> frozenset:
    """The top-level modules, of the network's ``names``, that take no
    update (``_param_labels``): under ``train_renv`` all but ``renv_net``;
    under ``train_env_only`` all but the env nets and ``renv_net``; and those
    ``frozen_mlps`` names."""
    if opt.train_renv:
        return frozenset(n for n in names if n != "renv_net")
    frozen = {MLP_NAMES[n] for n in ("specular", "diffuse", "renv") if n in opt.frozen_mlps}
    if opt.train_env_only:
        frozen |= {n for n in names if n not in ENV_MODULES}
    return frozenset(frozen)


class Adam:
    """The optax chain of ``make_optimizer`` (``trainer.py:82-108``) for each
    parameter group: clip to global norm 10, Adam(b1 0.9, b2 0.99, eps 1e-15),
    scale by ``0.1 ** min(count / iters, 1)`` and by ``-lr``; the whole update
    applied only if every gradient is finite (``optax.apply_if_finite``).

    The modules of ``frozen`` form optax's ``set_to_zero`` group: no update,
    no moments, no part in a clip norm; but ``apply_if_finite`` wraps the
    whole ``multi_transform``, so their gradients enter the finite check.

    Two counters, as optax keeps them: ``count`` (``ScaleByAdamState``)
    drives the bias correction and ``sched_count`` (``ScaleByScheduleState``)
    the lr decay.  They are equal unless a resume re-timed the schedule
    (:meth:`retime`).  The finite flag, the moments and the counters stay on
    the device; each state takes ``torch.where(finite, new, old)``, so a
    skipped update leaves every tensor bit-equal.  A parameter without a
    gradient takes a zero one, as in optax.
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
        self.count = torch.zeros((), dtype=torch.int64, device=device)        # bias correction
        self.sched_count = torch.zeros((), dtype=torch.int64, device=device)  # lr decay
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)      # not finite

    def bind(self, net: NeRFNetwork):
        """Read the groups of ``net``'s parameters.  After a module swap a
        parameter that is still there keeps its moments; a new one starts
        with zero moments."""
        old = {id(p): mv for p, mv in zip(getattr(self, "params", []), zip(self.m, self.v))}
        params = {k: [] for k in self.base}
        self.frozen, self.names = [], {}
        for name, module in net.named_children():
            dst = (self.frozen if name in self.frozen_names
                   else params[_GROUP_OF.get(name, "net")])
            dst.extend(module.parameters())
            self.names.update({id(p): f"{name}.{k}" for k, p in module.named_parameters()})
        self.groups = [(self.base[k], ps) for k, ps in params.items() if ps]
        self.params = [p for _, ps in self.groups for p in ps]
        mv = [old.get(id(p)) or (torch.zeros_like(p), torch.zeros_like(p)) for p in self.params]
        self.m, self.v = [m for m, _ in mv], [v for _, v in mv]

    def decay(self) -> torch.Tensor:
        """The lr factor of the next update, ``0.1 ** min(sched_count / iters, 1)``."""
        return 0.1 ** torch.clamp(self.sched_count.float() / self.iters, max=1.0)

    @torch.no_grad()
    def retime(self, step: int):
        """A fresh optimizer whose lr schedule stands at ``step``: zero moments,
        bias-correction count 0, schedule count ``step`` (``_retime_opt_state``)."""
        for t in (*self.m, *self.v):
            t.zero_()
        self.count.zero_()
        self.sched_count.fill_(step)

    @torch.no_grad()
    def load_optax_state(self, opt_state, net: NeRFNetwork):
        """Restore the moments and both counts from the JAX trainer's optax
        state (read through the checkpoint stand-ins): ``apply_if_finite``
        over ``multi_transform``, one ``masked`` chain per group label, whose
        moments hold the whole pytree with ``MaskedNode`` at the other
        groups' leaves."""
        states = opt_state.inner_state.inner_states
        index = {id(p): i for i, p in enumerate(self.params)}
        counts = set()
        for name, module in net.named_children():
            if name in self.frozen_names:
                continue
            chain = states[_GROUP_OF.get(name, "net")].inner_state
            adam = next(s for s in chain if isinstance(s, ScaleByAdamState))
            sched = next(s for s in chain if isinstance(s, ScaleByScheduleState))
            counts.add((int(adam.count), int(sched.count)))
            for p, m, v in zip(module.parameters(), module_arrays(module, adam.mu[name]),
                               module_arrays(module, adam.nu[name])):
                i = index[id(p)]
                for dst, src in ((self.m[i], m), (self.v[i], v)):
                    if tuple(dst.shape) != np.shape(src):
                        raise ValueError(f"{name}: moment of shape {np.shape(src)} "
                                         f"for a parameter of {tuple(dst.shape)}")
                    dst.copy_(torch.from_numpy(np.asarray(src, np.float32)))
        if len(counts) != 1:
            raise ValueError(f"the groups' counts differ: {sorted(counts)}")
        (count, sched_count), = counts
        self.count.fill_(count)
        self.sched_count.fill_(sched_count)
        self.skipped.fill_(int(opt_state.total_notfinite))

    def state_dict(self) -> Dict[str, Any]:
        """The moments by parameter name and the counters, as numpy."""
        def arrays(ts):
            return {self.names[id(p)]: t.detach().cpu().numpy() for p, t in zip(self.params, ts)}
        return {"count": int(self.count), "sched_count": int(self.sched_count),
                "skipped": int(self.skipped), "m": arrays(self.m), "v": arrays(self.v)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]):
        for p, m, v in zip(self.params, self.m, self.v):
            name = self.names[id(p)]
            m.copy_(torch.from_numpy(np.asarray(state["m"][name])))
            v.copy_(torch.from_numpy(np.asarray(state["v"][name])))
        self.count.fill_(int(state["count"]))
        self.sched_count.fill_(int(state["sched_count"]))
        self.skipped.fill_(int(state["skipped"]))

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
        decay = self.decay()
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
        self.sched_count += finite
        self.skipped += ~finite


class Trainer:
    def __init__(self, opt: Options, cfg: NetworkConfig, *, device=None,
                 seed: Optional[int] = None, net: Optional[NeRFNetwork] = None,
                 mesh: Optional[Group] = None):
        """``mesh``, a process group of several ranks (``parallel/mesh.py``),
        trains ray-data-parallel: each rank holds the whole model and takes
        its share of every batch's rays (:meth:`_train_on`)."""
        self.opt, self.cfg = opt, cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self._reduce = RayReduce(self.mesh)
        seed = opt.seed if seed is None else seed
        if net is None:
            net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)
        if opt.color_mlp_path:        # before the EMA copy, as trainer.py:129-141
            self.resume_mlps(opt.color_mlp_path, opt.resume_mlps)
        replicate_tree(self.mesh, self.net)     # rank 0's parameters everywhere
        self.ema_net = copy.deepcopy(self.net).requires_grad_(False)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.optimizer = Adam(self.net, opt, self.device,
                              frozen_modules(opt, [n for n, _ in self.net.named_children()]))
        self.use_grid = not (opt.env_sph_mode or opt.render_env_on_sphere)
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
        self.obj_aabb = (torch.tensor(opt.obj_aabb, dtype=torch.float32, device=self.device)
                         * opt.scale if opt.obj_aabb else None)
        self.workspace = opt.workspace
        self.stats: Dict[str, Any] = {"loss": [], "results": [], "ckpts": [],
                                      "best_result": None}
        # [len(dataset), 128*128] error per coarse cell, made at the first epoch
        self.error_map: Optional[torch.Tensor] = None
        self.epoch = 0
        self.global_step = 0
        # running mean of samples per ray (< 0: none yet), f64 on the device
        # so that it equals the reference's host EMA in Python floats
        self.mean_count = torch.full((), -1.0, dtype=torch.float64, device=self.device)
        self.host_mean_count = -1.0      # its value at the last epoch's end
        self._sched: Optional[StepSchedule] = None
        self._K = 0
        self._order: list = []
        self._images = None
        self._lpips_meter: Optional[LPIPSMeter] = None    # made by the first evaluate

    @property
    def applied_steps(self) -> torch.Tensor:
        """Updates applied since the moments started (Adam's bias-correction
        count), a device tensor."""
        return self.optimizer.count

    @property
    def notfinite(self) -> torch.Tensor:
        """Updates skipped for non-finite gradients, a device tensor."""
        return self.optimizer.skipped

    # ------------------------------------------- pretrained MLPs, relighting

    def resume_mlps(self, path: str, which):
        """Load the MLPs ``which`` names (``specular``, ``diffuse``, ``renv``,
        ``diffuse_env``, ``specular_env``) from a JAX checkpoint (``.ckpt``: its ``ema`` if it
        has one, else ``params``) or a reference ``.pth``, merged as
        ``Trainer._resume_mlps`` merges them (:func:`merge_mlp`).  ``all``
        first loads every module of the file that the network has (the
        encoder's and the density's leaves too, each into the leading corner
        of its own).  An unknown name raises, and so does a module that the
        file or the network lacks (the JAX trainer skips both)."""
        if path.endswith(".ckpt"):
            payload = read_checkpoint(path)
            loaded = payload["ema"] if "ema" in payload else payload["params"]
        else:
            loaded = torch_import.network_params_from_state(torch_import.load_state_dict(path))
        if "all" in which:      # the whole pretrained renderer (trainer.py:190-205)
            for name, module in list(self.net.named_children()):
                if name not in loaded:
                    continue
                setattr(self.net, name, merge_module(module, loaded[name], name))
            which = [w for w in which if w != "all"]
        for w in which:
            if w not in MLP_NAMES:
                raise ValueError(f"resume_mlps={w!r}: not one of {sorted(MLP_NAMES)}")
            name = MLP_NAMES[w]
            if name not in loaded or not hasattr(self.net, name):
                raise ValueError(f"resume_mlps={w!r}: {path} or the network has no {name}")
            setattr(self.net, name, merge_mlp(getattr(self.net, name), loaded[name]))

    def swap_env_net(self, path: str, split_diffuse: bool = False):
        """Relighting (``trainer.py:216-229``): the env net of ``path`` (an
        ``env_net_{i}.pth``) replaces ``env_net`` in the net and in the EMA
        net; with ``split_diffuse`` (and a ``diffuse_env_net``) the old env
        net first becomes the diffuse env net.  Where a module's widths equal
        the incoming ones its weights are copied in place and the optimizer
        keeps its moments, as the JAX trainer keeps its state; otherwise the
        module is replaced and its moments start at zero."""
        layers = torch_import.load_env_net(path)
        for net in (self.net, self.ema_net):
            if split_diffuse and hasattr(net, "diffuse_env_net"):
                old = module_tree(net.env_net, list(net.env_net.parameters()))
                self._assign_mlp(net, "diffuse_env_net", old)
            self._assign_mlp(net, "env_net", layers)
        self.ema_net.requires_grad_(False)
        self.optimizer.bind(self.net)

    def _assign_mlp(self, net, name: str, layers):
        """Set ``net.<name>`` to the JAX-layout MLP ``layers``: in place where
        the shapes agree, else as a new module."""
        mod = getattr(net, name)
        same = len(mod) == len(layers) and all(
            tuple(l.weight.shape) == p["w"].shape[::-1] and (l.bias is None) == ("b" not in p)
            for l, p in zip(mod, layers))
        if not same:
            setattr(net, name, mlp_from_tree(layers).to(self.device))
            return
        with torch.no_grad():
            for l, p in zip(mod, layers):
                l.weight.copy_(torch.from_numpy(np.ascontiguousarray(p["w"].T)))
                if l.bias is not None:
                    l.bias.copy_(torch.from_numpy(np.asarray(p["b"])))

    # ------------------------------------------------------------ grid

    def update_extra_state(self, full: bool = False):
        """Refresh the occupancy grid: whole-grid sweeps for the first 16
        updates (or ``full``), a rotating quarter slab afterwards.  Sphere
        mode has no grid."""
        if not self.use_grid:
            return
        lm = (level_mask(self._sched.enabled_levels, self.cfg.num_levels, self.device)
              if self._sched is not None else None)
        net = self.net

        def density_fn(x):    # NeuS: the alpha of one default step, no normals
            geo = net.forward_geometry(x, lm)
            return net.sdf_to_sigma(geo["sdf"]) if self.cfg.use_sdf else geo["sigma"]

        fraction = 1 if (full or self.grid.iter_density < 16) else 4
        with obs.span("grid.refresh"):
            with torch.no_grad():
                self.grid = update_grid(self.grid, self.grid_spec, density_fn,
                                        self.generator, fraction=fraction)
            # every rank drew the same cells; rank 0's grid makes them bit-equal
            replicate_tree(self.mesh, self.grid[:3])

    def mark_untrained_grid(self, poses, intrinsics):
        """Mark the grid cells that no camera of ``poses`` [B, 4, 4] sees as
        untrained (``trainer.py:306-310``); the JAX CLI calls it before scene
        training; sphere mode has no grid."""
        if self.use_grid:
            self.grid = mark_untrained(self.grid, self.grid_spec, poses, intrinsics)

    def train_geometric_cue(self, steps: int = 500, points: int = 131072,
                            radius: Optional[float] = None, *, given_points=None):
        """Pre-fit the SDF to a sphere of radius ``bound * scale``
        (``trainer.py:265-300``): ``steps`` updates of the main optimizer
        (its moments and counters, as in JAX) on ``mean((sdf - (|x| - r))^2)``
        over ``points`` points drawn uniformly in ``[-bound, bound]^3`` from
        the trainer's generator, or over ``given_points[i]`` at step ``i``
        (over a process group, each rank its share of them).
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
            pts = shard_rays(self.mesh, pts)
            sdf = self.net.forward_geometry(pts)["sdf"]
            loss = self._reduce.mean((sdf - (torch.linalg.vector_norm(pts, dim=-1) - r)) ** 2)
            loss.backward()
            all_reduce_grads(self.mesh, self.net.parameters())
            self.optimizer.step()
            for p in self.net.parameters():
                p.grad = None
            losses.append(loss.detach())
        self.ema_net.load_state_dict(self.net.state_dict())
        with obs.host_sync():
            return torch.stack(losses).tolist()

    # ---------------------------------------------------------- budgets

    def sample_budget(self, sched: StepSchedule, mean_count: Optional[float] = None) -> int:
        """Per-ray sample budget K from the running mean sample count (read
        from the device unless given)."""
        if self.opt.samples_budget > 0:
            return self.opt.samples_budget
        cap = sched.early_stop_steps if sched.early_stop_steps > 0 \
            else min(sched.max_steps, 1024)
        if mean_count is None:
            with obs.host_sync():                        # the epoch's one read
                mean_count = float(self.mean_count)
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
        with obs.host_sync():
            mean_count = float(self.mean_count)
        if self.opt.samples_budget <= 0 and mean_count > 0:
            est = min(int(mean_count * 1.5) + 8, cap)
            k = max(16, self.opt.min_samples_budget)
            while k < est:
                k *= 2
            K = min(K, k)
        return int(K)

    # ------------------------------------------------------------ step

    def _next_index(self, dataset):
        if not self._order:
            self._start_epoch(dataset)
        return self._order.pop(0)

    def _image_batch(self) -> int:
        """Views a scene-mode step trains on (``image_batch``, main_nerf.py:156)."""
        return self.opt.image_batch if self.use_grid and self.opt.image_batch > 1 else 1

    def _start_epoch(self, dataset):
        """The next epoch's schedule, beta cap, error map, K and shuffled
        order (``trainer.py:580-602``)."""
        self.epoch += 1
        self._sched = resolve(self.opt, self.epoch, self.global_step)
        if self._beta_capped():
            # project the learned Laplace beta under the epoch's cap
            # (trainer.py:585-593); no host sync
            with torch.no_grad():
                self.net.sdf_density.beta.clamp_(max=self._sched.weights["_beta_cap"])
        self._ensure_error_map(dataset)
        self._K = self.sample_budget(self._sched) if self.use_grid else 0
        rng = np.random.default_rng(self.opt.seed * 100003 + self.epoch)
        self._order = [int(i) for i in dataset.epoch_order(rng)]
        B = self._image_batch()
        if B > 1:
            # B views a step; the trailing partial group wrap-padded, so that
            # every view trains each epoch (the reference's drop_last=False)
            order = self._order + self._order[:(-len(self._order)) % B]
            self._order = [tuple(order[g:g + B]) for g in range(0, len(order), B)]

    def _ensure_error_map(self, dataset):
        if self.opt.error_map and self.error_map is None:
            # sized by the dataset (provider.py:277-281), 0.1 everywhere
            self.error_map = torch.full((len(dataset), ERROR_MAP_CELLS), 0.1,
                                        device=self.device)

    def train_one_epoch(self, dataset) -> Dict[str, float]:
        """One epoch (``trainer.py:580-680``): the next epoch's shuffled order,
        the whole of it, through :meth:`train_step` (a partial epoch's
        leftover is dropped first; the first step starts the epoch, as
        :meth:`step_may_sync` expects).  Returns the average of each step
        metric, ``notfinite`` at the epoch's end, ``time`` (seconds) and
        ``rays_per_sec`` (rays of the epoch over ``time``), and appends the
        mean loss to ``stats["loss"]``.  The steps' metrics stay on the
        device; the host reads them, with the mean-count EMA, once, at the
        end (:attr:`host_mean_count` keeps that reading)."""
        t0 = time.time()
        self._order = []
        steps = [self.train_step(dataset)]
        steps += [self.train_step(dataset) for _ in range(len(self._order))]
        n = len(steps)
        keys = [k for k, v in steps[0].items() if torch.is_tensor(v) and k != "notfinite"]
        means = torch.stack([torch.stack([m[k].double() for k in keys]) for m in steps]).mean(0)
        read = torch.cat([means, self.notfinite.double()[None],
                          torch.as_tensor(self.mean_count, dtype=torch.float64)[None]])
        with obs.host_sync():
            read = read.tolist()
        avg = dict(zip(keys, read[:len(keys)]))
        avg["notfinite"] = read[len(keys)]
        self.host_mean_count = read[-1]
        avg["time"] = time.time() - t0
        avg["rays_per_sec"] = self._sched.num_rays * n / avg["time"]
        self.stats["loss"].append(avg["loss"])
        return avg

    def train_one_epoch_steps(self, dataset, n_steps: int) -> Dict[str, float]:
        """``n_steps`` ad-hoc steps on the frames ``0, 1, ...`` of
        ``dataset`` (the viewer's train-per-frame loop, ``trainer.py:949-990``)
        under the schedule of ``max(epoch, 1)``; the epoch and its order are
        left as they were.  Returns the last loss and the step count."""
        self._sched = resolve(self.opt, max(self.epoch, 1), self.global_step)
        self._ensure_error_map(dataset)
        self._K = self.sample_budget(self._sched) if self.use_grid else 0
        B = self._image_batch()
        for i in range(n_steps):
            m = self._train_on(dataset, i % len(dataset) if B == 1 else
                               tuple((i * B + b) % len(dataset) for b in range(B)))
        with obs.host_sync():
            return {"loss": float(m["loss"]), "steps": n_steps}

    def _refreshes_grid(self) -> bool:
        every = self._sched.update_extra_interval
        return self.use_grid and every > 0 and self.global_step % every == 0

    def step_may_sync(self) -> bool:
        """Whether the next :meth:`train_step` may block the host: the first
        step (it copies the dataset to the device) and, in scene mode, the
        first step of an epoch (it reads the mean count to choose K) and a
        grid-refresh step."""
        return self._images is None or (
            self.use_grid and (not self._order or self._refreshes_grid()))

    def _beta_capped(self) -> bool:
        cfg = self.cfg
        return bool(self.opt.beta_cap_sched) and cfg.use_sdf and not cfg.use_neus_sdf

    def indirect_options(self, K: int, sched: Optional[StepSchedule] = None) -> IndirectOptions:
        """The secondary pass of a train step (``K`` its budget, ``sched`` its
        epoch; ``trainer.py:469-490``) or, with ``sched`` None, of an eval
        render (``:760-794``)."""
        opt = self.opt
        return IndirectOptions(
            indir_max_steps=opt.indir_max_steps,
            indir_early_stop_steps=opt.indir_early_stop_steps,
            indir_num_samples=(max(opt.indir_early_stop_steps, 16) if sched is None
                               else min(K, max(opt.indir_early_stop_steps, 16))),
            grad_rays=sched is not None and sched.grad_rays,
            grad_rays_scale=opt.grad_rays_scale)

    def sphere_options(self, sched: Optional[StepSchedule] = None) -> SphereRenderOptions:
        """The sphere shell of a train step (``sched`` its epoch) or, with
        ``sched`` None, of an eval render (``trainer.py:362-368, 793``)."""
        if sched is None:
            return SphereRenderOptions(radius=self.opt.env_sph_radius)
        flags = sched.flags
        return SphereRenderOptions(
            num_step=SPHERE_STEPS, step_size=SPHERE_STEP_SIZE, radius=self.opt.env_sph_radius,
            perturb=True, training=True, with_surf_sdf=flags.use_sdf_loss,
            with_backsdf=flags.use_backsdf_loss or flags.use_eikonal_loss)

    def forward_loss(self, rays_o, rays_d, gt_rgb, bg, alpha_mask, *, K: int,
                     sched: StepSchedule, noise=None, strat_noise=None, material=None,
                     env_index=0, r_images=None, volsdf_draws=None):
        """Render the rays with the live parameters and assemble the losses:
        -> (loss, render outputs, detached loss terms).  ``noise`` [N]
        perturbs the march, ``strat_noise`` [N, K] in [0, 1) jitters the
        samples (``stratified_sampling``).  Under ``sched.indir_ref`` the
        rays go through the three-pass render, and each of the two holds one
        draw per pass (:func:`render_scene_indirect`).  Under
        ``sched.error_bound`` they go through VolSDF's sampler
        (:func:`render_volsdf`), whose draws ``volsdf_draws`` (``noise``,
        ``u``, ``perm``) holds or the trainer's generator makes.  In sphere
        mode the rays go through :func:`render_sphere` with the frame's
        ``material``, ``env_index`` and ``r_images`` (``noise`` [N, 12]
        jitters the shell).  Before ``color_net_start_iter`` the net renders
        the diffuse term alone."""
        with self.net.diffuse_only(sched.diffuse_only):
            return self._forward_loss(rays_o, rays_d, gt_rgb, bg, alpha_mask, K=K, sched=sched,
                                      noise=noise, strat_noise=strat_noise, material=material,
                                      env_index=env_index, r_images=r_images,
                                      volsdf_draws=volsdf_draws)

    def volsdf_options(self) -> VolSDFOptions:
        """The error-bound sampler of a train step (``trainer.py:488-498``)."""
        opt = self.opt
        return VolSDFOptions(num_steps=opt.num_steps, upsample_steps=max(opt.upsample_steps, 16),
                             min_near=opt.min_near, perturb=True, training=True)

    def _forward_loss(self, rays_o, rays_d, gt_rgb, bg, alpha_mask, *, K, sched, noise,
                      strat_noise, material, env_index, r_images, volsdf_draws):
        opt, w, flags, cfg = self.opt, sched.weights, sched.flags, self.cfg
        ropts = SceneRenderOptions(
            max_steps=sched.max_steps, num_samples=K,
            early_stop_steps=sched.early_stop_steps, dt_gamma=opt.dt_gamma,
            T_thresh=opt.T_thresh, min_near=opt.min_near, perturb=noise is not None,
            training=True, grid_size=self.grid_spec.grid_size,
            coarse_march=opt.coarse_march, stratified_sampling=opt.stratified_sampling,
            with_loss_aux=(flags.use_relsdf_loss or flags.use_backsdf_loss
                           or flags.use_orientation_loss or flags.use_dist_bound
                           or flags.use_entropy_loss),
            use_bg_net=cfg.bg_radius > 0)
        laplace = cfg.use_sdf and not cfg.use_neus_sdf
        # the epoch's cap as a device tensor (a fill, no host-to-device copy)
        beta_cap = (torch.full((), w["_beta_cap"], device=self.device)
                    if self._beta_capped() else None)
        shared = dict(
            noise=noise, strat_noise=strat_noise,
            level_mask=level_mask(sched.enabled_levels, cfg.num_levels, self.device),
            normal_anneal_ratio=sched.normal_anneal_ratio,
            # the epoch's anneal, read afresh each step (nothing compiles it in)
            cos_anneal_ratio=sched.cos_anneal_ratio, beta_cap=beta_cap,
            beta_min=w["_beta_min"] if opt.beta_min_sched and laplace else None)
        if not self.use_grid:
            out = render_sphere(self.net, self.sphere_options(sched), rays_o, rays_d, bg,
                                material=material, env_index=env_index, r_images=r_images,
                                noise=noise, level_mask=shared["level_mask"],
                                normal_anneal_ratio=sched.normal_anneal_ratio)
        elif sched.indir_ref:
            out = render_scene_indirect(self.net, ropts, self.indirect_options(K, sched),
                                        self.grid.bitfield, rays_o, rays_d, bg, self.aabb,
                                        obj_aabb=self.obj_aabb, **shared)
        elif sched.error_bound:
            out = render_volsdf(self.net, self.volsdf_options(), rays_o, rays_d, bg, self.aabb,
                                level_mask=shared["level_mask"], beta_min=shared["beta_min"],
                                beta_cap=beta_cap, generator=self.generator,
                                **(volsdf_draws or {}))
        else:
            out = render_scene(self.net, ropts, self.grid.bitfield, rays_o, rays_d, bg,
                               self.aabb, **shared)
        with obs.span("loss"):
            beta = neus_inv_s = None
            if laplace:          # the loss-side beta (trainer.py:515-518)
                beta = density_ops.laplace_beta(self.net.sdf_density.beta, w["_beta_min"],
                                                cfg.beta_max)
                if beta_cap is not None:
                    beta = torch.minimum(beta, beta_cap)
            elif cfg.use_sdf:
                neus_inv_s = torch.clamp(torch.exp(self.net.sdf_density.variance * 10.0),
                                         1e-6, 1e6)
            loss, terms = compute_losses(out, gt_rgb, flags, w, alpha_mask=alpha_mask,
                                         beta=beta, neus_inv_s=neus_inv_s,
                                         roughness=out.get("roughness"), reduce=self._reduce)
        return loss, out, terms

    def _apply_update(self):
        """Skip-if-non-finite, per-group clip, decayed lr, Adam, EMA (of the
        trainable parameters: a frozen one stays equal to its EMA copy).
        Over a process group the gradients are first summed across ranks, so
        that every rank takes the same update."""
        all_reduce_grads(self.mesh, self.net.parameters())
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
        its terms, (in scene mode) the step's mean sample count and
        ``notfinite`` as detached device tensors (nothing is read back), the
        epoch's ``K`` and the frame's ``index`` in the dataset.
        ``refresh_grid=False`` skips the grid refresh that falls on this step
        (a benchmark times the steps alone, as ``bench.py`` does).  In sphere
        mode the frame's material, env index and mirror-sphere image
        condition the render.  The step is the root span ``train_step``
        (``obs.py``), its id the step's ``global_step``."""
        with obs.span("train_step", self.global_step):
            return self._train_on(dataset, self._next_index(dataset), refresh_grid)

    def _train_on(self, dataset, idx, refresh_grid: bool = True) -> Dict[str, object]:
        """One step on view ``idx`` of ``dataset``, or on the views of a
        tuple ``idx`` (an image batch).  Over a process group every rank
        draws the whole batch (rays, pixels, background, jitter, VolSDF's
        draws) from the same generator and keeps its share of the rays."""
        sched, opt = self._sched, self.opt
        if refresh_grid and self._refreshes_grid():
            self.update_extra_state()
        with obs.span("rays"):
            if self._images is None or self._images[0] is not dataset:
                sphere = not self.use_grid
                self._images = (dataset, dataset.device_images(self.device),
                                torch.as_tensor(dataset.poses, device=self.device),
                                dataset.conditioning(self.device) if sphere else None,
                                dataset.device_r_images(self.device) if sphere else None,
                                pixel_max(dataset.images.dtype))
            _, images, poses, cond, r_all, top = self._images
            H, W, N = dataset.H, dataset.W, sched.num_rays
            if isinstance(idx, tuple):    # the rays split across the views, plain draws
                # a stack of views, not an index tensor: no host-to-device copy
                rays = sampled_rays(self.generator, torch.stack([poses[i] for i in idx]),
                                    dataset.intrinsics, H, W, N // len(idx))
                view = torch.stack([images[i] for i in idx])
                pix = torch.gather(view, 1, rays["inds"][..., None].expand(-1, -1, view.shape[-1]))
                rays_o, rays_d = rays["rays_o"].reshape(-1, 3), rays["rays_d"].reshape(-1, 3)
                pix = self._pixels(pix.reshape(-1, view.shape[-1]), top)
            else:
                pose = poses[idx][None]
                if sched.use_error_map:     # importance sampling from the image's error map
                    rays = error_map_rays(self.generator, pose, dataset.intrinsics, H, W, N,
                                          self.error_map[idx][None])
                elif opt.patch_size > 1:    # square patches (utils.py:565)
                    rays = patch_rays(self.generator, pose, dataset.intrinsics, H, W, N,
                                      opt.patch_size)
                elif opt.center_crop > 0:
                    rays = center_crop_rays(self.generator, pose, dataset.intrinsics, H, W, N,
                                            opt.center_crop, opt.center_crop_ratio)
                else:
                    rays = sampled_rays(self.generator, pose, dataset.intrinsics, H, W, N)
                rays_o, rays_d, inds = rays["rays_o"][0], rays["rays_d"][0], rays["inds"][0]
                pix = self._pixels(images[idx][inds], top)
            n = pix.shape[0]      # patches round the ray count down
            if dataset.C == 4 and self.cfg.bg_radius <= 0:
                if opt.alpha_bg_mode == "white":
                    bg = torch.ones((n, 3), device=self.device)
                else:
                    bg = torch.rand((n, 3), generator=self.generator, device=self.device)
                gt_rgb = pix[..., :3] * pix[..., 3:] + bg * (1.0 - pix[..., 3:])
                alpha_mask = pix[..., 3]
            else:       # the background net draws the background: the alpha is unused
                bg = torch.ones((n, 3), device=self.device)
                gt_rgb, alpha_mask = pix[..., :3], None
            noise = strat_noise = volsdf = None
            frame = {}
            if not self.use_grid:       # the shell's jitter and the frame's conditioning
                noise = torch.rand((n, SPHERE_STEPS), generator=self.generator, device=self.device)
                row = cond[idx]
                frame = dict(material=row[:5], env_index=row[5].long(),
                             r_images=None if r_all is None else self._pixels(
                                 r_all[idx][inds], pixel_max(dataset.r_images.dtype)))
            elif opt.stratified_sampling:     # jitter the samples, not the march
                if sched.indir_ref:         # one draw a pass, the secondary at its budget
                    k2 = self.indirect_options(self._K, sched).indir_num_samples
                    strat_noise = [torch.rand((n, k), generator=self.generator, device=self.device)
                                   for k in (self._K, k2, self._K)]
                else:
                    strat_noise = torch.rand((n, self._K), generator=self.generator,
                                             device=self.device)
            elif not sched.error_bound:       # VolSDF draws its own jitter
                shape = (3, n) if sched.indir_ref else (n,)
                noise = torch.rand(shape, generator=self.generator, device=self.device)
            elif self.mesh is not None and not sched.indir_ref:
                # the global batch's VolSDF draws, in the order the render makes them
                volsdf = volsdf_draws(self.volsdf_options(), n, self.generator, self.device)
            if self.mesh is not None:         # this rank's share of the rays
                sl = ray_sharded(self.mesh, n)
                rays_o, rays_d, gt_rgb, bg, alpha_mask = shard_rays(
                    self.mesh, rays_o, rays_d, gt_rgb, bg, alpha_mask)
                if noise is not None:     # [n], [n, 12] (sphere) or [3, n] (one a pass)
                    noise = noise[:, sl] if self.use_grid and noise.dim() == 2 else noise[sl]
                if strat_noise is not None:
                    strat_noise = ([t[sl] for t in strat_noise] if isinstance(strat_noise, list)
                                   else strat_noise[sl])
                if frame.get("r_images") is not None:
                    frame["r_images"] = frame["r_images"][sl]
                if volsdf is not None:
                    volsdf = {k: v if k == "perm" else v[sl] for k, v in volsdf.items()}

        loss, out, terms = self.forward_loss(rays_o, rays_d, gt_rgb, bg, alpha_mask,
                                             K=self._K, sched=sched, noise=noise,
                                             strat_noise=strat_noise, volsdf_draws=volsdf,
                                             **frame)
        with obs.span("backward"):
            # into the parameters alone: the normals' sample points are leaves
            # that require a gradient, and theirs would be computed for nothing
            loss.backward(inputs=[p for p in self.net.parameters() if p.requires_grad])
        with obs.span("update"):
            self._apply_update()
        if sched.use_error_map:      # the per-ray EMA of the image's error (:547-555)
            err = global_from_local(self.mesh, (out["image"].detach() - gt_rgb).abs().mean(dim=-1))
            self.error_map[idx] = update_error_row(self.error_map[idx],
                                                   rays["inds_coarse"][0], err)
        extra = {}
        if "counts" in out:       # a march's sample count (VolSDF has none)
            mc = self._reduce.mean(out["counts"].float())
            prev = torch.as_tensor(self.mean_count, dtype=torch.float64, device=self.device)
            self.mean_count = torch.where(prev < 0, mc.double(),
                                          0.9 * prev + 0.1 * mc.double())
            extra["mean_count"] = mc
            obs.count("march.slots", n * self._K)
            obs.count_later("march.samples", mc, n)
        self.global_step += 1
        if "renv_mask" in out:     # share of the marched samples the renv gate opens to
            extra["renv_open"] = (self._reduce.sum(out["renv_mask"])
                                  / self._reduce.sum(out["mask"]).clamp_min(1)).detach()
        return {**terms, **extra, "loss": loss.detach(), "notfinite": self.notfinite.clone(),
                "K": self._K, "index": idx}

    def _pixels(self, pix: torch.Tensor, top: int = 255) -> torch.Tensor:
        """Pixels as floats in [0, 1], the colour linearised under
        ``color_space=linear`` (``trainer.py:437-455``): integers divided by
        ``top``, the largest value of the decoded image's dtype (255 for
        uint8, 65535 for uint16, 1 for 1-bit grey); floats (an
        ``fp16_preload`` copy) are already divided.  The JAX step divides
        every integer image by 255 (ROADMAP, "Known divergences")."""
        pix = pix.float() if pix.is_floating_point() else pix.float() / top
        if self.opt.color_space == "linear":
            pix = torch.cat([srgb_to_linear(pix[..., :3]), pix[..., 3:]], dim=-1)
        return pix

    # ------------------------------------------------------------ eval

    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor, *, use_ema: bool = True,
                    bg_color: float = 1.0, material=None, env_index=0,
                    r_images: Optional[torch.Tensor] = None,
                    env_rot_radian=None) -> Dict[str, torch.Tensor]:
        """Render rays [N, 3] in chunks of ``eval_ray_chunk`` (no gradient):
        in scene mode through the grid (a model with the renv branch that
        trains the indirect pass renders through the three passes,
        ``trainer.py:760-794``), in sphere mode the sphere with ``material``,
        ``env_index`` and, where given, each ray's mirror-sphere colour
        ``r_images`` [N, C] (linear; the JAX eval passes none, so that the
        specular colour of a ``train_renv`` model then comes from the env
        branch, ``network.py:588-592``); ``env_rot_radian`` turns the
        environment about the y axis.  Over a process group each rank
        renders its share of the rays (the last ray repeated to an equal
        share) and the shares are all-gathered."""
        net = self.ema_net if use_ema else self.net
        n_rays = rays_o.shape[0]
        if self.mesh is not None:
            world = self.mesh.world
            pad = -n_rays % world

            def share(t):
                if t is None:
                    return None
                t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) if pad else t
                return t[ray_sharded(self.mesh, n_rays + pad)]
            rays_o, rays_d, r_images = share(rays_o), share(rays_d), share(r_images)
        opt = self.opt
        chunk = opt.eval_ray_chunk or 4096
        keep = ("image", "depth", "weights_sum", "normal_image", "diffuse_image",
                "specular_image", "roughness_image", "renv_mask_image")
        if self.use_grid:
            ropts = SceneRenderOptions(
                max_steps=opt.max_steps, num_samples=self.eval_samples_budget(),
                early_stop_steps=opt.early_stop_steps, dt_gamma=opt.dt_gamma,
                T_thresh=opt.T_thresh, min_near=opt.min_near,
                grid_size=self.grid_spec.grid_size, coarse_march=opt.coarse_march,
                use_bg_net=self.cfg.bg_radius > 0)
            indirect = self.cfg.use_renv and opt.indir_ref_start_iter > 0

            def render(o, d, _):
                if indirect:
                    return render_scene_indirect(net, ropts, self.indirect_options(0),
                                                 self.grid.bitfield, o, d, bg_color,
                                                 self.eval_aabb, obj_aabb=self.obj_aabb,
                                                 env_rot_radian=env_rot_radian)
                return render_scene(net, ropts, self.grid.bitfield, o, d, bg_color,
                                    self.eval_aabb, env_rot_radian=env_rot_radian)
        else:
            sopts = self.sphere_options()

            def render(o, d, r):
                return render_sphere(net, sopts, o, d, bg_color, material=material,
                                     env_index=env_index, r_images=r,
                                     env_rot_radian=env_rot_radian)
        parts: Dict[str, list] = {}
        with torch.no_grad():
            for s in range(0, rays_o.shape[0], chunk):
                r = None if r_images is None else r_images[s:s + chunk]
                res = render(rays_o[s:s + chunk], rays_d[s:s + chunk], r)
                for k in keep:
                    if k in res:
                        parts.setdefault(k, []).append(res[k])
        return {k: global_from_local(self.mesh, torch.cat(v))[:n_rays] for k, v in parts.items()}

    def render_image(self, pose, intrinsics, H: int, W: int, *, use_ema: bool = True,
                     bg_color: float = 1.0, material=None, env_index=0,
                     r_image=None, env_rot_radian=None) -> Dict[str, np.ndarray]:
        """:meth:`render_rays` of every pixel of a view, as numpy [H, W, ...];
        ``r_image`` uint8 [H, W, C] is the view's mirror-sphere image (sphere
        mode), linearised as a train step linearises it."""
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        rays_o, rays_d = full_image_rays(pose[None], intrinsics, H, W)
        r = None
        if r_image is not None:
            r_image = np.asarray(r_image)
            r = self._pixels(torch.as_tensor(r_image, device=self.device).reshape(H * W, -1),
                             pixel_max(r_image.dtype))
        res = self.render_rays(rays_o[0], rays_d[0], use_ema=use_ema, bg_color=bg_color,
                               material=material, env_index=env_index, r_images=r,
                               env_rot_radian=env_rot_radian)
        return {k: v.reshape((H, W) + v.shape[1:]).cpu().numpy() for k, v in res.items()}

    def evaluate(self, dataset, *, max_images: int = 8, use_ema: bool = True,
                 track_best: bool = True, indices=None, env_rot_degree_range=None,
                 dump_dir: Optional[str] = None) -> float:
        """PSNR, SSIM and LPIPS of the renders of a split's first ``max_images``
        views (or of ``indices``) against its images, on the test-time
        background (``trainer.py:817-904``; one :class:`LPIPSMeter` a
        trainer, on its device, its kind in ``lpips_kind``).  A split
        without images (a colmap test path) is rendered, not scored,
        and tracks no best.  ``env_rot_degree_range`` ``(d0, d1, k)`` renders
        each view again at ``k`` env rotations (not scored); ``dump_dir``
        receives each render's images (:meth:`_dump_visuals`).  The results
        join ``stats["results"]``; with ``track_best`` a new best PSNR saves
        the ``best`` checkpoint (without optimizer state).  Returns the mean
        PSNR."""
        psnr_meter, ssim_meter = PSNRMeter(), SSIMMeter()
        if self._lpips_meter is None:
            self._lpips_meter = LPIPSMeter(device=self.device)
        lpips_meter = self._lpips_meter
        lpips_meter.clear()
        idxs = list(indices) if indices else list(range(min(len(dataset), max_images)))
        has_gt = getattr(dataset, "images", None) is not None
        track_best = track_best and has_gt
        rots = [None]
        if env_rot_degree_range:
            d0, d1, k = env_rot_degree_range
            rots = list(np.deg2rad(np.linspace(d0, d1, int(k))))
        for i in idxs:
            for ri, rot in enumerate(rots):
                res = self.render_view(dataset, i, use_ema=use_ema, env_rot_radian=rot)
                if rot is None and has_gt:
                    pred, gt = eval_pair(res, dataset, i, self.opt)
                    psnr_meter.update(pred, gt)
                    ssim_meter.update(pred, gt)
                    lpips_meter.update(pred, gt)
                if dump_dir is not None:
                    self._dump_visuals(res, srgb_image(res, self.opt), dump_dir,
                                       f"{i:03d}" + (f"_rot{ri}" if rot is not None else ""))
        psnr = psnr_meter.measure()
        lpips = lpips_meter.measure() if lpips_meter.N else None
        self.stats["results"].append({"psnr": psnr, "ssim": ssim_meter.measure(),
                                      "lpips": lpips, "lpips_kind": lpips_meter.kind,
                                      "epoch": self.epoch})
        best = self.stats.get("best_result")
        if track_best and (best is None or psnr > best):
            self.stats["best_result"] = psnr
            self.stats["best_result_ssim"] = ssim_meter.measure()
            if lpips is not None:
                self.stats["best_result_lpips"] = lpips
            self.save_checkpoint(name="best", full=False)
        return psnr

    def _dump_visuals(self, res: Dict[str, np.ndarray], pred_srgb: np.ndarray, outdir: str,
                      tag: str):
        """The render's images as PNGs (``trainer.py:905-930``): ``{tag}_rgb``,
        ``{tag}_normal`` and the ``visual_items`` of diffuse, specular and
        roughness.  Every file is a PNG: the port has no JPEG or EXR writer
        (JAX's ``img_format=jpg`` writes ``.jpg``)."""
        os.makedirs(outdir, exist_ok=True)
        write_png(os.path.join(outdir, f"{tag}_rgb.png"), to_uint8(pred_srgb))
        if "normal_image" in res:
            write_png(os.path.join(outdir, f"{tag}_normal.png"),
                      to_uint8(res["normal_image"] * 0.5 + 0.5))
        items = set(self.opt.visual_items)
        for key, name in VISUALS:
            if name in items and key in res:
                v = res[key]
                if v.shape[-1] == 1:
                    v = np.repeat(v, 3, -1) / max(float(v.max()), 1e-6)
                write_png(os.path.join(outdir, f"{tag}_{name}.png"), to_uint8(v))

    def render_view(self, dataset, i: int, *, use_ema: bool = True,
                    with_r_image: bool = False, env_rot_radian=None) -> Dict[str, np.ndarray]:
        """:meth:`render_image` of a split's view ``i`` on the test-time
        background; in sphere mode with the view's material (the unwrap
        material under ``overwrite_materials``) and env index (or
        ``set_env_net_index`` when it is above 0), and with ``with_r_image``
        its mirror-sphere image (``trainer.py:817-866``); ``env_rot_radian``
        turns the environment."""
        kw = {}
        if not self.use_grid:
            opt = self.opt
            material = dataset.material(i)
            if opt.overwrite_materials:     # utils.py:835-838
                material = dict(material, roughness=opt.unwrap_roughness,
                                metallic=opt.unwrap_metallic, color=list(opt.unwrap_color))
            env_index = int(dataset.env_index[i])
            if opt.set_env_net_index > 0:    # utils.py:825-826
                env_index = opt.set_env_net_index
            kw = dict(material=material, env_index=env_index,
                      r_image=dataset.r_images[i] if with_r_image else None)
        return self.render_image(dataset.poses[i], dataset.intrinsics, dataset.H, dataset.W,
                                 use_ema=use_ema, bg_color=eval_bg(self.opt),
                                 env_rot_radian=env_rot_radian, **kw)

    # ------------------------------------------------------ checkpoints

    def save_checkpoint(self, name: Optional[str] = None, full: bool = True) -> str:
        """Write ``<workspace>/checkpoints/<name>.ckpt`` (``trainer.py:1018-1046``):
        the JAX package's keys as plain numpy pytrees (``epoch``,
        ``global_step``, ``iters``, ``mean_count``, ``stats``, ``params``,
        ``ema``, ``grid`` and ``error_map``), so that its ``load_checkpoint``
        reads the file, and with ``full`` the port's optimizer state under
        ``torch_optimizer`` (which JAX ignores: it re-times its schedule).
        Epoch checkpoints rotate, ``max_keep_ckpt`` of them kept; ``best``
        is never rotated, nor is a file outside this workspace's
        ``checkpoints/`` (a resumed ``stats["ckpts"]`` names the files of the
        run that wrote it).  Over a process group only rank 0 writes.
        Returns the path."""
        name = name or f"ep{self.epoch:04d}"
        directory = os.path.join(self.workspace, "checkpoints")
        path = os.path.join(directory, f"{name}.ckpt")
        if self.rank != 0:      # rank 0 writes for the group
            return path
        g = self.grid
        payload = {
            "epoch": self.epoch, "global_step": self.global_step, "iters": self.opt.iters,
            "mean_count": float(self.mean_count), "stats": copy.deepcopy(self.stats),
            "params": network_tree(self.net), "ema": network_tree(self.ema_net),
            "grid": (g.density.cpu().numpy(), g.bitfield.cpu().numpy(),
                     g.mean_density.cpu().numpy(), np.asarray(g.iter_density, np.int32)),
        }
        if self.error_map is not None:
            payload["error_map"] = self.error_map.cpu().numpy()
        if full:
            payload["torch_optimizer"] = self.optimizer.state_dict()
        os.makedirs(directory, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        if name != "best":
            self.stats["ckpts"].append(path)
            while len(self.stats["ckpts"]) > self.opt.max_keep_ckpt:
                old = self.stats["ckpts"].pop(0)
                if (os.path.dirname(os.path.abspath(old)) == os.path.abspath(directory)
                        and os.path.exists(old)):
                    os.remove(old)
        return path

    def find_checkpoint(self, which: Optional[str] = None) -> Optional[str]:
        """The path ``which`` names (``trainer.py:1048-1062``): ``None`` or
        ``latest`` the last, by name, of the workspace's ``checkpoints/``,
        ``ep*`` files before ``emergency_*`` dumps; ``best`` its
        ``best.ckpt`` where there is one (else as ``latest``); any other
        value is a path.  None when the directory holds no checkpoint."""
        if which not in (None, "latest", "best"):
            return which
        directory = os.path.join(self.workspace, "checkpoints")
        cands = sorted(os.listdir(directory)) if os.path.isdir(directory) else []
        if which == "best" and "best.ckpt" in cands:
            cands = ["best.ckpt"]
        else:
            cands = [c for c in cands if c.startswith("ep")] or cands
        return os.path.join(directory, cands[-1]) if cands else None

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """Read a checkpoint of the JAX package or of :meth:`save_checkpoint`
        (``path`` as :meth:`find_checkpoint` reads it; with none found, warn,
        keep the fresh state and return False) and resume as
        ``Trainer.load_checkpoint`` there does (``trainer.py:1048-1103``):
        ``epoch``, ``global_step``,
        ``mean_count``, ``stats``, ``params``, ``ema``, ``grid`` and
        ``error_map``; the optimizer from the file's state (the port's own,
        or JAX's ``opt_state``: the Adam moments group by group and both
        counts); a file without one re-times the lr schedule to
        ``global_step``, with fresh moments, so that the first resumed step
        takes the decayed lr and not the base lr.  Returns True."""
        path = self.find_checkpoint(path)
        if path is None:
            warnings.warn(f"no checkpoint in {self.workspace}/checkpoints; starting fresh")
            return False
        payload = read_checkpoint(path)
        self.epoch = int(payload["epoch"])
        self.global_step = int(payload["global_step"])
        self.host_mean_count = float(payload.get("mean_count", -1.0))
        self.mean_count = torch.tensor(self.host_mean_count, dtype=torch.float64,
                                       device=self.device)
        self.stats = payload.get("stats", self.stats)
        load_jax_params(self.net, payload["params"])
        load_jax_params(self.ema_net, payload["ema"])
        density, bitfield, mean_density, iter_density = payload["grid"]
        self.grid = OccupancyGrid(
            density=torch.from_numpy(np.asarray(density, np.float32)).to(self.device),
            bitfield=torch.from_numpy(np.asarray(bitfield, bool)).to(self.device),
            mean_density=torch.tensor(float(mean_density), device=self.device),
            iter_density=int(iter_density))
        if "error_map" in payload:
            self.error_map = torch.from_numpy(
                np.asarray(payload["error_map"], np.float32)).to(self.device)
        restored = False
        try:
            if "torch_optimizer" in payload:
                self.optimizer.load_state_dict(payload["torch_optimizer"])
                restored = True
            elif "opt_state" in payload:
                self.optimizer.load_optax_state(payload["opt_state"], self.net)
                restored = True
        except (KeyError, ValueError, AttributeError, StopIteration) as e:
            warnings.warn(f"{path}: the optimizer state does not fit ({e!r}); "
                          "starting a fresh one")
        if not restored and self.global_step > 0:
            self.optimizer.retime(self.global_step)
        if payload.get("iters") not in (None, self.opt.iters):
            warnings.warn(f"opt.iters={self.opt.iters} differs from the checkpoint's "
                          f"{payload['iters']}: the lr decay 0.1^(step/iters) jumps")
        self._sched, self._order = None, []
        return True


def eval_bg(opt: Options) -> float:
    return 1.0 if opt.render_bg_color == "white" else 0.0


def srgb_image(res: Dict[str, np.ndarray], opt: Options) -> np.ndarray:
    """A render's image in sRGB (from linear radiance under
    ``color_space=linear``), not clipped."""
    pred = res["image"]
    if opt.color_space == "linear":
        pred = linear_to_srgb(torch.from_numpy(pred)).numpy()
    return pred


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats as uint8, clipped and truncated, as the JAX apps write them."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def eval_pair(res: Dict[str, np.ndarray], dataset, i: int, opt: Options):
    """(render, ground truth) of view ``i`` as ``Trainer.evaluate`` compares
    them, from ``res`` of :meth:`Trainer.render_view`: the render in sRGB
    clipped to [0, 1], the image composited on the test-time background."""
    bg = eval_bg(opt)
    pred = srgb_image(res, opt)
    gt = dataset.images[i].astype(np.float32) / pixel_max(dataset.images.dtype)
    if gt.shape[-1] == 4:
        gt = gt[..., :3] * gt[..., 3:] + bg * (1.0 - gt[..., 3:])
    return np.clip(pred, 0.0, 1.0), gt


def update_error_row(row: torch.Tensor, inds_coarse: torch.Tensor,
                     err: torch.Tensor) -> torch.Tensor:
    """One image's error map after a step: each drawn cell takes
    ``0.9 * old + 0.1 * err`` of its ray (``trainer.py:547-555``).  Where
    several rays drew one cell the last of them wins, by a rule that does
    not depend on the order of a scatter's writes: the ``amax`` of the ray
    indices that drew each cell picks the ray."""
    vals = 0.9 * row[inds_coarse] + 0.1 * err
    ray = torch.arange(inds_coarse.shape[0], device=row.device)
    last = torch.full(row.shape, -1, dtype=torch.long, device=row.device).scatter_reduce(
        0, inds_coarse, ray, "amax")
    return torch.where(last >= 0, vals[last.clamp_min(0)], row)


def read_checkpoint(path: str) -> dict:
    """A checkpoint of the JAX package, read by :class:`_ArrayUnpickler`."""
    with open(path, "rb") as f:
        return _ArrayUnpickler(f).load()


# Stand-ins for the optax state tuples that a full JAX checkpoint pickles
# (field for field; optax is not imported, nor installed on the card).
EmptyState = collections.namedtuple("EmptyState", [])
MaskedNode = collections.namedtuple("MaskedNode", [])
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", ["count"])
PartitionState = collections.namedtuple("PartitionState", ["inner_states"])
MaskedState = collections.namedtuple("MaskedState", ["inner_state"])
ApplyIfFiniteState = collections.namedtuple(
    "ApplyIfFiniteState", ["notfinite_count", "last_finite", "total_notfinite", "inner_state"])
_OPTAX_STANDINS = {
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState,
    ("optax.transforms._combining", "PartitionState"): PartitionState,
    ("optax.transforms._conditionality", "ApplyIfFiniteState"): ApplyIfFiniteState,
    ("optax.transforms._masking", "MaskedState"): MaskedState,
    ("optax.transforms._masking", "MaskedNode"): MaskedNode,
}
# the numpy globals a checkpoint may name: the array reconstruction
# (numpy 2 pickles them under numpy._core, numpy 1 under numpy.core)
_CKPT_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("numpy.core.multiarray", "_reconstruct"),
                 ("numpy.core.multiarray", "scalar")}


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and the optax state tuples above in plain
    containers and refuses every other global, so a checkpoint cannot run
    code when it is read."""

    def find_class(self, module, name):
        if (module, name) in _OPTAX_STANDINS:
            return _OPTAX_STANDINS[(module, name)]
        canon = module.replace("numpy._core", "numpy.core", 1)
        if (canon, name) not in _CKPT_GLOBALS:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}, not a part of a numpy array "
                "or an optax state")
        if canon == "numpy":
            return getattr(np, name)
        try:
            mod = importlib.import_module("numpy._core.multiarray")
        except ImportError:
            mod = importlib.import_module("numpy.core.multiarray")
        return getattr(mod, name)
