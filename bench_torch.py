"""Benchmark of the PyTorch port on one CUDA card: scene-training throughput
(rays/s, forward and backward) and eval-render throughput.

    python3 bench_torch.py

The counterpart of ``bench.py``: the trainer of ``ENVIDR_BENCH_CONFIG``
(default ``configs/synth_spheres_cp.ini``) at ``ENVIDR_BENCH_RAYS`` rays a
step (default: the config's), on the in-memory sphere scene.  One grid
refresh, 3 warm-up steps, 20 timed steps (no grid refresh among them), then
one 400x400 view rendered twice and the second render timed.  Then the
data-parallel probe (``envidr_tpu_torch/tools/bench_scaling.py``: 1 and 2
ranks as processes sharing the one card) gives ``bench.py``'s two GSPMD
keys, ``gspmd_overhead_ratio`` and ``weak_rays_per_sec_per_vdev``; a failed
probe fails the benchmark.  Prints ONE JSON line with ``bench.py``'s keys.
Without a card it exits non-zero and prints nothing.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
# the port's first run of the default config, synth_spheres_cp.ini at 4096
# rays, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md)
BASELINE_RAYS_PER_SEC = 38908.1
WARMUP, STEPS = 3, 20


def run(config_path: str = DEFAULT_CONFIG, *, num_rays: int = 0, device=None,
        warmup: int = WARMUP, steps: int = STEPS, downscale: int = 1, scaling: bool = False,
        **overrides) -> dict:
    """Time the train step and the eval render; returns ``bench.py``'s keys,
    with ``scaling`` the data-parallel probe's two as well (on the card).
    ``downscale`` shrinks the rendered view (the tests' CPU runs);
    ``overrides`` go to the config loader."""
    import torch
    from envidr_tpu_torch import resolve_device
    from envidr_tpu_torch.config import card_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    if num_rays:
        overrides["num_rays"] = num_rays
    opt = card_options(config_path, **overrides)
    device = resolve_device(device)
    trainer = Trainer(opt, network_config(opt), device=device)
    data = SynthSpheres("train", scale=opt.scale)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    trainer.update_extra_state()
    for _ in range(warmup):
        m = trainer.train_step(data, refresh_grid=False)
    float(m["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(data, refresh_grid=False)
    sync()
    dt = time.perf_counter() - t0
    rays_per_sec = opt.num_rays * steps / dt
    out = {
        "metric": "train_rays_per_sec_fwd_bwd",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "config": os.path.basename(config_path),
        "coarse_march": bool(opt.coarse_march),
    }
    view = SynthSpheres("train", n=1, scale=opt.scale, downscale=downscale)
    for _ in range(2):                 # the second render is timed
        t0 = time.perf_counter()
        res = trainer.render_image(view.poses[0], view.intrinsics, view.H, view.W,
                                   use_ema=False)
        float(res["image"].sum())
    out["eval_rays_per_sec"] = round(view.H * view.W / (time.perf_counter() - t0), 1)
    if scaling:
        from envidr_tpu_torch.tools import bench_scaling
        del trainer                    # the probe's processes take the card
        torch.cuda.empty_cache()
        row = bench_scaling.measure(config_path)
        out["gspmd_overhead_ratio"] = row["gspmd_overhead_ratio"]
        out["weak_rays_per_sec_per_vdev"] = row["weak_rays_per_sec_per_vdev"]
        out["scaling"] = row
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; the port runs on the card only", file=sys.stderr)
        return 2
    config = os.environ.get("ENVIDR_BENCH_CONFIG", DEFAULT_CONFIG)
    rays = int(os.environ.get("ENVIDR_BENCH_RAYS") or 0)
    print(json.dumps(run(config, num_rays=rays, scaling=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
