"""Device-time breakdown of the scene train step on the card.

    python3 -m envidr_tpu_torch.train.profile_step [--config INI] [--steps 5] [--out FILE]

Builds the full-width trainer of ``--config`` (default
``configs/synth_spheres_cp.ini``, the repo's main path; a hash-grid config
takes the kernel path, ``config.card_options``), takes warm-up steps, times
``--steps`` steps, then traces as many with ``torch.profiler``.  Prints the wall time per step
with the profiler off and on, the device busy time per step (the device time
of the operators' kernels, memsets and copies, as the profiler's own "Self
CUDA time total" counts it; one stream, so nothing overlaps) and its share
of the untraced wall time, the peak memory, the operators that take the
most device time, and ``aten::index_add_`` (the encoder's table gradients)
by input shape.  Then the step's stages alone, at the step's shapes, in
CUDA-event ms (:func:`stage_ms`).  ``--out`` also writes it all to a file.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from envidr_tpu_torch.config import card_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.geometry.rays import near_far_from_aabb, sampled_rays
from envidr_tpu_torch.ops.compositing import weights_from_alphas
from envidr_tpu_torch.ops.hashgrid import EncoderGradGate
from envidr_tpu_torch.ops.marching import march_rays
from envidr_tpu_torch.train.trainer import Trainer

WARMUP = 5
STAGE_REPS = 10
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _event_ms(fn, reps: int = STAGE_REPS) -> float:
    """Mean CUDA-event ms of ``fn`` over ``reps`` calls after two warm-up."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_ms(trainer: Trainer, data: SynthSpheres) -> dict:
    """The train step's stages run alone on one step's rays and samples:
    the march; the position encoder's forward, its input gradient (with
    create_graph, for the normals) and the backward of an eikonal-plus-linear
    loss through both (the table gradients of the first and second order);
    the compositing weights' forward and backward.  What a stage costs inside
    the step also depends on its neighbours, so these attribute the step's
    time only roughly."""
    opt, net, K = trainer.opt, trainer.net, trainer._K
    sched = trainer._sched
    dev = trainer.device
    pose = torch.as_tensor(data.poses[:1], device=dev)
    rays = sampled_rays(trainer.generator, pose, data.intrinsics, data.H, data.W,
                        sched.num_rays)
    rays_o, rays_d = rays["rays_o"][0], rays["rays_d"][0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, trainer.aabb, opt.min_near)

    def march():
        return march_rays(rays_o, rays_d, nears, fars, trainer.grid.bitfield,
                          bound=trainer.cfg.bound, grid_size=trainer.grid_spec.grid_size,
                          max_steps=sched.max_steps, num_samples=K,
                          early_stop_steps=sched.early_stop_steps,
                          coarse_march=opt.coarse_march)

    xyz = march().xyzs.reshape(-1, 3)
    gen = torch.Generator(device=dev).manual_seed(0)
    cot = torch.randn(xyz.shape[0], trainer.cfg.pos_enc_dim, device=dev, generator=gen)
    w = torch.randn(trainer.cfg.pos_enc_dim, device=dev, generator=gen)

    def encode():
        gate = EncoderGradGate()
        pts = xyz.detach().requires_grad_(True)
        enc = net.encode_position(pts, None, gate)
        gate.skip_table_grad = True
        (g,) = torch.autograd.grad((enc @ w).sum(), pts, create_graph=True)
        gate.skip_table_grad = False
        (((g.norm(dim=-1) - 1.0) ** 2).sum() + (enc * cot).sum()).backward()
        net.zero_grad(set_to_none=True)

    alphas = torch.rand(rays_o.shape[0], K, device=dev, generator=gen).requires_grad_(True)

    def composite():
        weights_from_alphas(alphas, T_thresh=opt.T_thresh).sum().backward()

    return {"points": xyz.shape[0], "march_ms": _event_ms(march),
            "encode_fwd_grad_grad2_ms": _event_ms(encode),
            "composite_fwd_bwd_ms": _event_ms(composite)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(ROOT, "configs", "synth_spheres_cp.ini"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    opt = card_options(args.config)
    trainer = Trainer(opt, network_config(opt))
    data = SynthSpheres("train", scale=opt.scale)
    for _ in range(WARMUP):
        trainer.train_step(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(args.steps):
        trainer.train_step(data)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
    events = prof.key_averages()
    # operator events carry their kernels' device time; kernel rows and user
    # annotations would count it twice
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and not e.is_user_annotation) / 1e3 / args.steps
    head = (f"device: {torch.cuda.get_device_name(0)}\n"
            f"config: {os.path.basename(args.config)}\n"
            f"steps: {args.steps} after {WARMUP} warm-up, K={trainer._K}, "
            f"rays={opt.num_rays}\n"
            f"peak_mem_gib: {torch.cuda.max_memory_allocated() / 2**30:.3f}\n"
            f"wall_ms_per_step: {plain_wall_ms:.3f} (profiler off), "
            f"{wall_ms:.3f} (profiler on)\n"
            f"device_busy_ms_per_step: {busy_ms:.3f} "
            f"busy_share_of_unprofiled_wall: {busy_ms / plain_wall_ms:.3f}\n")
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    by_shape = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                       if e.key == "aten::index_add_"),
                      key=lambda e: -e.self_device_time_total)
    table += "\naten::index_add_ by input shape (device ms per step, calls per step):\n"
    table += "".join(f"  {e.input_shapes}  {e.self_device_time_total / 1e3 / args.steps:.3f}"
                     f"  {e.count / args.steps:g}\n" for e in by_shape)
    stages = stage_ms(trainer, data)
    step_ms = plain_wall_ms
    table += "stages alone (CUDA-event ms, mean of %d): %s  rest_of_step_ms=%.3f\n" % (
        STAGE_REPS, " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in stages.items()),
        step_ms - sum(v for k, v in stages.items() if k.endswith("_ms")))
    print(head + table, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(head + table)


if __name__ == "__main__":
    main()
