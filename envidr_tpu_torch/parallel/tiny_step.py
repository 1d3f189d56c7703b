"""A tiny but real CP train step for multi-process validation, and the
worker process that runs one rank of a data-parallel group.

Counterpart of ``envidr_tpu/parallel/tiny_step.py`` (``tiny_options``,
``tiny_batch``, ``run_tiny_step``: the full scene train step at toy shapes)
and of ``tests/mp_worker.py`` (the worker).  One rank a process:

    python -m envidr_tpu_torch.parallel.tiny_step COORDINATOR WORLD RANK OUTDIR MODE
        [--device cuda|cpu] [--config INI] [--rays N] [--steps N] [--ckpt CKPT]
        [--cp-dtype float32|bfloat16] [--set KEY=VALUE] [--backend B]

``COORDINATOR`` is ``host:port``; ``WORLD`` 1 runs alone without a process
group.  ``MODE``:

  * ``step``: one tiny step (:func:`run_tiny_step`, 16 rays a rank; ``--set
    KEY=VALUE`` its options);
  * ``eval``: the tiny model's render of the tiny view, and a 12-row
    tensor sharded over the ranks and gathered back;
  * ``train``: ``--config`` at its width on the in-memory sphere scene
    (``--rays`` in all), one step, then ``--steps`` timed steps
    (:func:`run_config`);
  * ``render``: ``--config`` with the checkpoint ``--ckpt``, val view 0 of
    the sphere scene at 400x400 (:func:`render_checkpoint`);
  * ``allreduce``: one all-reduce of a tensor on ``--device``.

Each rank writes ``OUTDIR/<mode>_<rank>.npz``: its parameters (by name),
and the mode's readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from envidr_tpu_torch import resolve_device

TINY_H = TINY_W = 16
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_options(n_devices: int, **overrides):
    """The JAX package's tiny CP options, ``16 * n_devices`` rays in all."""
    from envidr_tpu_torch.config import Options, finalize

    return finalize(Options(**{**dict(
        use_sdf=True, encoding_pos="cp", cp_rank=8, num_levels=8,
        desired_resolution=128, log2_hashmap_size=10,
        num_layers=2, num_layers_color=2, num_layers_diffuse=2,
        num_layers_env=2, hidden_dim_env=32, geo_feat_dim=12, env_feat_dim=12,
        use_diffuse=True, diffuse_with_env=True, use_env_net=True,
        use_reflected_dir=True, encoding_ref="integrated_dir",
        use_n_dot_viewdir=True, normal_with_mlp=True, wo_viewdir=True,
        use_roughness=True, ensemble_mlp=True, mlp_bias=True,
        net_init="xavier_uniform", geo_feat_act="unitNorm",
        env_feat_act="unitNorm", color_loss="l1",
        eikonal_loss_weight=0.001, mask_loss_weight=0.1,
        num_rays=16 * max(n_devices, 1), max_steps=64, early_stop_steps=8,
        samples_budget=8, bound=1.0, dt_gamma=0.0, density_thresh=0.01,
        workspace=os.path.join(tempfile.gettempdir(), "envidr_dryrun"), iters=100,
    ), **overrides}))


def tiny_batch(H: int = TINY_H, W: int = TINY_W):
    """The JAX package's tiny view: a seeded uint8 RGBA image [H*W, 4], a
    pose 2.5 units down the z axis and its intrinsics (numpy)."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (H * W, 4), dtype=np.uint8)
    pose = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5], [0, 0, 0, 1]], np.float32)
    return {"pose": pose, "image": image, "intrinsics": np.asarray([20.0, 20.0, 8.0, 8.0])}


class TinyView:
    """:func:`tiny_batch` as a one-view dataset (the interface the trainer
    reads)."""

    def __init__(self, H: int = TINY_H, W: int = TINY_W):
        b = tiny_batch(H, W)
        self.H, self.W, self.C = H, W, 4
        self.images = b["image"].reshape(1, H, W, 4)
        self.poses = b["pose"][None]
        self.intrinsics = tuple(float(v) for v in b["intrinsics"])

    def __len__(self):
        return 1

    def epoch_order(self, rng):
        return np.arange(1)

    def device_images(self, device) -> torch.Tensor:
        return torch.from_numpy(self.images.reshape(1, self.H * self.W, 4)).to(device)


def set_cp_dtype(trainer, cp_dtype: Optional[str]):
    """Run the trainer's CP encoder (net and EMA net) in ``cp_dtype``
    (``float32`` or ``bfloat16``, the configs' default); None leaves it."""
    if cp_dtype:
        for net in (trainer.net, trainer.ema_net):
            net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype=cp_dtype)


def tiny_trainer(group, n_devices: int, device=None, cp_dtype: Optional[str] = None,
                 **overrides):
    """The tiny trainer (``overrides`` on :func:`tiny_options`), at epoch 1
    with its sample budget, its error map (where ``error_map`` is set) and a
    populated occupancy grid, as step 0 leaves them; ``cp_dtype`` as
    :func:`set_cp_dtype`."""
    from envidr_tpu_torch.config import network_config
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt = tiny_options(n_devices, **overrides)
    trainer = Trainer(opt, network_config(opt), device=device, mesh=group)
    set_cp_dtype(trainer, cp_dtype)
    trainer._sched = resolve(opt, 1, 0)
    trainer._K = trainer.sample_budget(trainer._sched)
    trainer._ensure_error_map(TinyView())
    trainer.update_extra_state()
    return trainer


def run_tiny_step(group, n_devices: int, device=None, cp_dtype: Optional[str] = None,
                  **overrides):
    """Build the tiny trainer and take ONE full train step on the tiny view
    -> (metrics, trainer, delta): ``delta`` the summed |change| of the first
    SDF layer's weight."""
    trainer = tiny_trainer(group, n_devices, device, cp_dtype, **overrides)
    w0 = trainer.net.sdf_net[0].weight.detach().clone()
    metrics = trainer._train_on(TinyView(), 0)
    delta = float((trainer.net.sdf_net[0].weight.detach() - w0).abs().sum())
    return metrics, trainer, delta


def param_arrays(net) -> dict:
    """Every parameter and buffer of ``net`` as numpy, by name."""
    out = {f"param/{k}": v.detach().cpu().numpy() for k, v in net.named_parameters()}
    out.update({f"buffer/{k}": v.detach().cpu().numpy() for k, v in net.named_buffers()})
    return out


def state_arrays(trainer) -> dict:
    """The replicated state a rank holds: parameters, EMA, grid, the Adam
    moments (by parameter name) and counters, the mean count."""
    out = param_arrays(trainer.net)
    out.update({f"ema/{k}": v for k, v in param_arrays(trainer.ema_net).items()})
    g = trainer.grid
    out.update({"grid/density": g.density.cpu().numpy(), "grid/bitfield": g.bitfield.cpu().numpy(),
                "grid/mean_density": g.mean_density.cpu().numpy()})
    adam = trainer.optimizer
    for p, m, v in zip(adam.params, adam.m, adam.v):
        name = adam.names[id(p)]
        out[f"adam/m/{name}"], out[f"adam/v/{name}"] = m.cpu().numpy(), v.cpu().numpy()
    out["adam/count"] = adam.count.cpu().numpy()
    out["mean_count"] = trainer.mean_count.cpu().numpy()
    if trainer.error_map is not None:
        out["error_map"] = trainer.error_map.cpu().numpy()
    return out


def run_config(group, config: str, *, device=None, num_rays: int = 0, steps: int = 10,
               warmup: int = 3, cp_dtype: Optional[str] = None) -> dict:
    """``config`` (through ``card_options``; the CP encoder in ``cp_dtype``
    where given) on the in-memory sphere scene,
    ``num_rays`` in all (0: the config's): one grid refresh, one step (the
    state after it under ``step1/``), ``warmup`` more, then ``steps`` timed
    steps without grid refresh (``ms_per_step``, the median of the steps'
    host times after a device sync each), and the state after them under
    ``last/``.  Every rank of ``group`` runs the same calls."""
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    overrides = {"num_rays": num_rays} if num_rays else {}
    opt = card_options(config, **overrides)
    device = resolve_device(device)
    trainer = Trainer(opt, network_config(opt), device=device, mesh=group)
    set_cp_dtype(trainer, cp_dtype)
    data = SynthSpheres("train", scale=opt.scale)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    trainer.update_extra_state()
    m = trainer.train_step(data, refresh_grid=False)
    out = {"loss_1": float(m["loss"])}
    out.update({f"step1/{k}": v for k, v in state_arrays(trainer).items()})
    for _ in range(warmup):
        trainer.train_step(data, refresh_grid=False)
    times = []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        m = trainer.train_step(data, refresh_grid=False)
        sync()
        times.append(time.perf_counter() - t0)
    out["step_ms"] = np.asarray(times) * 1e3
    out["ms_per_step"] = float(np.median(times) * 1e3) if times else float("nan")
    out["rays"] = opt.num_rays
    out["loss_last"] = float(m["loss"])
    out["notfinite"] = int(trainer.notfinite)
    out.update({f"last/{k}": v for k, v in state_arrays(trainer).items()})
    return out


def render_checkpoint(group, config: str, ckpt: str, *, device=None) -> dict:
    """``config`` with the checkpoint ``ckpt``: val view 0 of the sphere
    scene at 400x400 (EMA weights), rendered twice and the second timed
    (``image``, ``render_s``)."""
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(config)
    device = resolve_device(device)
    trainer = Trainer(opt, network_config(opt), device=device, mesh=group)
    trainer.load_checkpoint(ckpt)
    val = SynthSpheres("val", n=1, scale=opt.scale)
    for _ in range(2):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)
        render_s = time.perf_counter() - t0
    return {"image": res["image"], "render_s": render_s}


def worker(group, mode: str, args) -> dict:
    """One rank's work for ``mode`` (module docstring)."""
    device = torch.device(args.device)
    if mode == "step":
        from envidr_tpu_torch.config import _parse_value
        overrides = {k: _parse_value(v) for k, v in (kv.split("=", 1) for kv in args.set)}
        metrics, trainer, delta = run_tiny_step(group, args.world, device, args.cp_dtype,
                                                **overrides)
        return {"loss": float(metrics["loss"]), "delta": delta, **state_arrays(trainer)}
    if mode == "eval":
        from envidr_tpu_torch.data.nerf_dataset import process_rank
        from envidr_tpu_torch.parallel.mesh import global_from_local, shard_rays

        trainer = tiny_trainer(group, args.world, device)
        view = TinyView()
        res = trainer.render_image(view.poses[0], view.intrinsics, view.H, view.W)
        rows = torch.arange(36, dtype=torch.float32, device=device).reshape(12, 3)
        local = shard_rays(group, rows)
        return {"image": res["image"], "depth": res["depth"], **param_arrays(trainer.net),
                "shard_local": local.cpu().numpy(),
                "shard_back": global_from_local(group, local).cpu().numpy(),
                "process_rank": np.asarray(process_rank())}
    if mode == "train":
        return run_config(group, args.config, device=device, num_rays=args.rays,
                          steps=args.steps, warmup=min(args.steps, 3),
                          cp_dtype=args.cp_dtype)
    if mode == "render":
        return render_checkpoint(group, args.config, args.ckpt, device=device)
    if mode == "allreduce":
        x = torch.arange(4, dtype=torch.float32, device=device) + (group.rank if group else 0)
        if group is not None:
            torch.distributed.all_reduce(x)
        return {"sum": x.cpu().numpy()}
    raise ValueError(f"unknown mode {mode!r}")


def free_port() -> int:
    """A free localhost port, from a socket bound to port 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, mode: str, outdir: str, *args: str, timeout: float = 600.0,
              threads: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """Run ``world`` worker processes (ranks 0 .. world-1) of ``mode`` with
    the worker arguments ``args``; each has ``timeout`` seconds, and all are
    killed when one overruns.  ``threads`` caps each process's CPU threads.
    Raises with a worker's output if one fails; returns each rank's arrays."""
    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    coordinator = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "envidr_tpu_torch.parallel.tiny_step", coordinator, str(world),
         str(rank), outdir, mode, *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {mode} exited {p.returncode}:\n{out[-3000:]}")
    return [dict(np.load(os.path.join(outdir, f"{mode}_{rank}.npz"))) for rank in range(world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("coordinator")
    p.add_argument("world", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("outdir")
    p.add_argument("mode", choices=["step", "eval", "train", "render", "allreduce"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--config", default=os.path.join(ROOT, "configs", "synth_spheres_cp.ini"))
    p.add_argument("--rays", type=int, default=0)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--cp-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="an option of the tiny step (mode step)")
    p.add_argument("--ckpt", default=os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt"))
    args = p.parse_args(argv)

    from envidr_tpu_torch.parallel import mesh

    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group: Optional[mesh.Group] = None
    if args.world > 1 or args.backend:
        group = mesh.initialize_multihost(args.coordinator, args.world, args.rank,
                                          device=args.device, backend=args.backend)
        args.device = str(group.device)
    try:
        out = worker(group, args.mode, args)
        if group is not None:
            out["backend"] = np.asarray(group.backend)
    finally:
        mesh.shutdown()
    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, f"{args.mode}_{args.rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
