"""Device-time breakdown of the scene train step on the card.

    python3 -m envidr_tpu_torch.train.profile_step [--steps 5] [--out FILE]

Builds the full-width ``configs/synth_spheres.ini`` trainer that
``chip_smoke.py`` drives (rolled_tiled hash grid, hand-written hash VJP,
``hash_scatter_impl=mixed``), takes warm-up steps, times ``--steps`` steps,
then traces as many with ``torch.profiler``.  Prints the wall time per step
with the profiler off and on, the device busy time per step (the device time
of the operators' kernels, memsets and copies, as the profiler's own "Self
CUDA time total" counts it; one stream, so nothing overlaps) and its share
of the untraced wall time, and the operators that take the most device
time.  ``--out`` also writes the table to a file.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.train.trainer import Trainer

WARMUP = 5
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad="on")
    trainer = Trainer(opt, network_config(opt))
    data = SynthSpheres("train", scale=opt.scale)
    for _ in range(WARMUP):
        trainer.train_step(data)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(args.steps):
        trainer.train_step(data)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
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
            f"steps: {args.steps} after {WARMUP} warm-up, K={trainer._K}, "
            f"rays={opt.num_rays}\n"
            f"wall_ms_per_step: {plain_wall_ms:.3f} (profiler off), "
            f"{wall_ms:.3f} (profiler on)\n"
            f"device_busy_ms_per_step: {busy_ms:.3f} "
            f"busy_share_of_unprofiled_wall: {busy_ms / plain_wall_ms:.3f}\n")
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(head + table, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(head + table)


if __name__ == "__main__":
    main()
