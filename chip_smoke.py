"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its numbers and the elapsed
seconds:

  device   card name and power limit (nvidia-smi)
  build    nvcc build of every kernel of the scene-training path
  kernels  each kernel against its plain PyTorch version at the shape the
           train step gives it, with CUDA-event times of the kernel, the plain
           version and one library call computing the same function
  parity   a small model, one train-step loss and its gradients on the card
           (through the kernels) against the same step on the CPU (plain
           versions)
  train    configs/synth_spheres.ini at full width (rolled_tiled hash grid,
           hash_scatter_impl=mixed, hand-written hash VJP) on the in-memory
           sphere scene: 20 train steps; launch counts are zeroed just before
  render   one 400x400 eval render of a val view, PSNR against the analytic
           ground truth; launch counts are read just after

Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the exit code
is non-zero; without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
TRAIN_STEPS = 20
SCATTER_ATOL = 1e-3                # f32 sums of ~64 unit-normal rows per slot
                                   # (level 0), added in another order
PARITY_RTOL = 2e-2                 # of each tensor's max |value|: this f32 step
                                   # is itself only good to ~1e-2 of its max
                                   # (hash-table grads, CPU f32 against f64), so
                                   # two summation orders may differ that much


def phase(name: str, *words, **numbers):
    fields = " ".join([*words, *(f"{k}={v}" for k, v in numbers.items())])
    print(f"{name}: {fields} elapsed_s={time.perf_counter() - T0:.1f}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def check_scatter(spec, B: int, W: int):
    """scatter_add_rows at the train step's shape: kernel vs plain vs library."""
    import numpy as np
    import torch
    from envidr_tpu_torch.ops import scatter

    L, s_max = spec.num_levels, spec.s_max
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, s, B) for s in spec.sizes]).astype(np.int32)
    idx = torch.from_numpy(idx).cuda()
    rows = torch.from_numpy(rng.standard_normal((L, B, W), dtype=np.float32)).cuda()
    flat_idx = (idx.long() + torch.arange(L, device="cuda")[:, None] * s_max).reshape(-1)
    flat_rows = rows.reshape(-1, W)

    def library():
        return torch.zeros((L * s_max, W), device="cuda").index_add_(0, flat_idx, flat_rows)

    before = scatter.KERNEL.launches
    out = scatter.scatter_add_rows(idx, rows, s_max)
    torch.cuda.synchronize()
    ref = scatter.scatter_add_rows_plain(idx, rows, s_max)
    err = float((out - ref).abs().max())
    if not err <= SCATTER_ATOL:
        raise AssertionError(f"scatter_add_rows disagrees with its plain version: "
                             f"max_abs_err={err} > {SCATTER_ATOL}")
    lib_err = float((library().reshape(L, s_max, W) - ref).abs().max())
    ms = cuda_ms(lambda: scatter.scatter_add_rows(idx, rows, s_max))
    plain_ms = cuda_ms(lambda: scatter.scatter_add_rows_plain(idx, rows, s_max))
    library_ms = cuda_ms(library)
    scatter.KERNEL.launches = before          # comparison launches do not count
    nbytes = L * B * 4 + L * B * W * 4 + L * s_max * W * 4
    return {
        "name": "scatter_add_rows", "route": "cuda",
        "source": "envidr_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "envidr_tpu/ops/pallas_scatter.py:64",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms,
    }, {"library_max_abs_err": lib_err, "shape": f"L={L} B={B} W={W} S_max={s_max}"}


def check_parity():
    """One small train-step loss + gradients: card (kernels) vs CPU (plain)."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad="on", num_levels=4,
                       log2_hashmap_size=12, desired_resolution=64, hidden_dim=16,
                       hidden_dim_color=16, hidden_dim_env=16)
    cfg = network_config(opt)
    sched = resolve(opt, 1, 0)
    gen = torch.Generator().manual_seed(3)
    rays_o = torch.randn(256, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 2.5])
    target = torch.rand(256, 3, generator=gen) * 0.6 - 0.3
    rays_d = torch.nn.functional.normalize(target - rays_o, dim=-1)
    gt = torch.rand(256, 3, generator=gen)
    alpha = (torch.rand(256, generator=gen) > 0.5).float()
    results = []
    for device in ("cpu", "cuda"):
        net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
        tr = Trainer(opt, cfg, device=device, net=net)
        tr.grid = tr.grid._replace(bitfield=torch.ones_like(tr.grid.bitfield))
        args = [t.to(device) for t in (rays_o, rays_d, gt, torch.ones(256, 3), alpha)]
        loss, out, terms = tr.forward_loss(*args, K=32, sched=sched)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in tr.net.named_parameters()}
        results.append((float(loss.detach()), out["image"].detach().cpu(), grads))
    (l0, im0, g0), (l1, im1, g1) = results
    errs = {"loss": abs(l0 - l1) / max(abs(l0), 1e-12),
            "image": float((im0 - im1).abs().max())}
    for n in g0:
        scale = max(float(g0[n].abs().max()), 1e-12)
        errs[n] = float((g0[n] - g1[n]).abs().max()) / scale
    worst = max(errs, key=errs.get)
    if not errs[worst] <= PARITY_RTOL:
        raise AssertionError(f"card and CPU train steps disagree: {worst} "
                             f"{errs[worst]} > {PARITY_RTOL}")
    return {"loss_cpu": l0, "loss_cuda": l1, "max_rel_err": errs[worst],
            "worst": worst, "tolerance": PARITY_RTOL}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.ops import scatter
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi))

    nvcc_s = scatter.KERNEL.build()
    phase("build", scatter_add_rows="cached" if nvcc_s is None else f"nvcc_s={nvcc_s:.1f}")

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad="on")
    cfg = network_config(opt)
    K0 = opt.early_stop_steps                        # the first epoch's budget
    row, info = check_scatter(cfg.hash_spec, B=opt.num_rays * K0, W=8 * cfg.level_dim)
    phase("kernels", "scatter_add_rows ok", max_abs_err=row["max_abs_err"],
          tol=SCATTER_ATOL, ms=row["ms"], plain_ms=row["plain_ms"],
          library_ms=row["library_ms"], bound_ms=row["bound_ms"],
          library_max_abs_err=info["library_max_abs_err"], shape=repr(info["shape"]))

    par = check_parity()
    phase("parity", **par)

    t = time.perf_counter()
    train = SynthSpheres("train", scale=opt.scale)
    val = SynthSpheres("val", scale=opt.scale)
    data_s = time.perf_counter() - t
    trainer = Trainer(opt, cfg)
    scatter.KERNEL.launches = 0                      # main path starts here
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    occupied = float(trainer.grid.bitfield.float().mean())
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        m = trainer.train_step(train)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"])
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"step {i + 1}: loss {m['loss']}")
    ms_per_step = float(np.mean(step_ms[3:]))
    launches_train = scatter.KERNEL.launches
    if launches_train < TRAIN_STEPS:
        raise AssertionError(f"scatter_add_rows launched {launches_train} times in "
                             f"{TRAIN_STEPS} steps; expected at least one per step")
    phase("train", steps=TRAIN_STEPS, loss_1=losses[0], loss_20=losses[-1],
          notfinite=trainer.notfinite, mean_samples_per_ray=m["mean_count"], K=m["K"],
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], grid_occupied=occupied,
          scatter_launches=launches_train,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, data_gen_s=data_s)

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)
    render_s = time.perf_counter() - t
    launches = scatter.KERNEL.launches               # main path ends here
    img = res["image"]
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    p = psnr(np.clip(img, 0.0, 1.0), gt)
    if img.shape != (val.H, val.W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"render: shape {img.shape}, finite {np.isfinite(img).all()}")
    if not np.isfinite(p) or float(img.std()) < 1e-4:
        raise AssertionError(f"render: psnr {p}, image std {img.std()}")
    phase("render", size=f"{val.H}x{val.W}", psnr_db=p, image_std=float(img.std()),
          seconds=render_s, rays_per_s=val.H * val.W / render_s)

    row["launches"] = launches
    print(json.dumps({"kernels": [row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
