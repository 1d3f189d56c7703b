"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its numbers and the elapsed
seconds:

  device   card name and power limit (nvidia-smi)
  build    nvcc build of every kernel source (one nvcc each, all started
           together), with the seconds of each or "cached"
  kernels  each kernel against its plain PyTorch version at the shape its
           path gives it (the train step for scatter_add_rows, the
           micro-benchmarks' shapes for the others), with CUDA-event times of
           the kernel, the plain version and, where there is one, a single
           library call computing the same function, beside the bound (the
           kernel's median and mean of 20 launches), after the timer's floor
           (an empty launch and a zero_() of the gathers' output, same
           timer); then readings of the bf16 accumulator's summation-order
           noise and the scatters' and gathers' edge shapes
           (envidr_tpu_torch.tools.scatter_edges)
  parity   a small model, one train-step loss and its gradients on the card
           (through the kernels) against the same step on the CPU (plain
           versions), and the CPU f32 step against an f64 one, per tensor
  hash     the ``hash`` encoder's forward and first/second-order gradients
           and the ``sorted`` scatter on the card against the CPU, small size
  train    configs/synth_spheres.ini at full width (rolled_tiled hash grid,
           hash_scatter_impl=mixed, hand-written hash VJP) on the in-memory
           sphere scene: 20 train steps, each step that neither starts an
           epoch nor refreshes the grid under torch.cuda's sync debug mode
           "error"; launch counts are zeroed just before
  render   one 400x400 eval render of a val view, PSNR against the analytic
           ground truth; launch counts are read just after
  bench    the three micro-benchmarks of envidr_tpu_torch.tools at their full
           shapes with few iterations (every table row, hash_encode of both
           indexings included); launch counts are zeroed just before and read
           just after

Then one JSON line of per-kernel numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the exit code
is non-zero; without a CUDA card it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
TRAIN_STEPS = 20
BENCH_ITERS = 4                    # timed calls per micro-benchmark row
SCATTER_ATOL = 1e-3                # f32 sums of ~64 unit-normal rows per slot
                                   # (level 0), added in another order
FEW_ROWS_ATOL = 1e-5               # f32 sums of the few (<= ~8) rows per slot
                                   # of a 2^19-row table, in another order
BF16_ACC_RTOL = 2.0**-5            # of max |sum|: bf16 sums of a few rows in
                                   # two orders that the atomics choose; the
                                   # bf16 readings below differ by up to 2
                                   # ulps of the largest sums, 2^-7 of max |sum|
                                   # or more, so 2^-5 (4-8 ulps) leaves room
HASH_FWD_ATOL = 1e-6               # one f32 product-sum of 8 corners
HASH_GRAD1_RTOL = 1e-5             # of max: f32 sums over 8 corners x levels
HASH_GRAD2_RTOL = 1.3e-3           # of max: double backward (ROADMAP C-3)
SORTED_ATOL = 1e-4                 # cumsum differences (the JAX package's bound)
BENCH = dict(B=262_144, W=16, S=1 << 19, S_small=4096)   # tools/bench_scatter.py:22-25,87
PARITY_RTOL = 5e-3                 # of each tensor's max |value|: the card and
                                   # the CPU sum in other orders; the largest
                                   # reading, card f32 against CPU f32, is
                                   # 1.30e-3 (sdf_net.0.weight; PERF.md), so this
                                   # is a margin of ~4x over it.  The f32 step is
                                   # itself 9.4e-3 from f64 on the table gradient
                                   # (the cpu_f32_vs_cpu_f64 reading)


def phase(name: str, *words, **numbers):
    fields = " ".join([*words, *(f"{k}={v}" for k, v in numbers.items())])
    print(f"{name}: {fields} elapsed_s={time.perf_counter() - T0:.1f}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_libraries():
    """(name, CudaLibrary) of every kernel instantiation, in table order."""
    import torch
    from envidr_tpu_torch.ops import gather, scatter
    return [("scatter_add_rows", scatter.KERNEL),
            ("gather_rows<f32>", gather.KERNEL),
            ("gather_rows<round_bf16>", gather.KERNEL_BF16),
            ("scatter_add_rows<round_bf16>", scatter.KERNEL_BF16),
            ("scatter_rows_tiled<f32>", scatter.TILED[torch.float32]),
            ("scatter_rows_tiled<bf16>", scatter.TILED[torch.bfloat16])]


def build_all():
    """One nvcc per source, all started together: {source stem: seconds|None}."""
    by_source = {lib.source: lib for _, lib in kernel_libraries()}
    with ThreadPoolExecutor(len(by_source)) as ex:
        secs = list(ex.map(lambda lib: lib.build(), by_source.values()))
    return {src.stem: s for src, s in zip(by_source, secs)}


def check_kernel(row, kernel, source, replaces, shape, run, plain, library, nbytes,
                 tol, bench_rows=None):
    """One kernel against its plain version on the same inputs, then timed
    (CUDA events, L2 flushed; the kernel's median, ``ms``, and mean of the
    same 20 launches) beside its plain version, the library call (``(name,
    fn)`` or None) and the bytes bound.  ``tol`` is an absolute tolerance or a
    callable of the plain result.  ``bench_rows`` is ``(micro-benchmark,
    row-name pattern)``: the rows that launch this kernel for this table
    row."""
    import statistics
    import torch
    from envidr_tpu_torch.tools._timing import cuda_time, cuda_times
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = float((out - ref).abs().max())
    tol = tol(ref) if callable(tol) else tol
    if not err <= tol:
        raise AssertionError(f"{kernel} ({shape}) disagrees with its plain version: "
                             f"max_abs_err={err} > {tol}")
    times = cuda_times(run, 20, 3)
    ms, mean_ms = statistics.median(times) * 1e3, statistics.fmean(times) * 1e3
    plain_ms = cuda_time(plain, 20, 3) * 1e3
    library_ms = None if library is None else cuda_time(library[1], 20, 3) * 1e3
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ms < bound_ms:
        raise AssertionError(f"{kernel} ({shape}) timed at {ms} ms, below its bound "
                             f"{bound_ms} ms: a measuring fault")
    result = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
              "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
              "row": row, "shape": shape, "tolerance": tol,
              "library": None if library is None else library[0], "bench_rows": bench_rows,
              "mean_ms": mean_ms}
    phase("kernels", f"row {row} {kernel} ok", shape=repr(shape), max_abs_err=err,
          tol=tol, ms=ms, mean_ms=mean_ms, plain_ms=plain_ms,
          library_ms="none" if library_ms is None else library_ms,
          library=repr(result["library"]), bound_ms=bound_ms)
    return result


def check_scatter(spec, B: int, W: int):
    """Row 1, scatter_add_rows at the train step's shape."""
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

    return check_kernel(
        "1", "scatter_add_rows", "envidr_tpu_torch/csrc/scatter_rows.cu",
        "envidr_tpu/ops/pallas_scatter.py:64", f"L={L} B={B} W={W} S_max={s_max}",
        lambda: scatter.scatter_add_rows(idx, rows, s_max),
        lambda: scatter.scatter_add_rows_plain(idx, rows, s_max),
        ("index_add_", library), L * B * 4 + L * B * W * 4 + L * s_max * W * 4,
        SCATTER_ATOL)


def launch_floor():
    """The timing harness's floor (the kernels phase's timer): an empty kernel
    launched through the gathers' ctypes and launch path, and ``zero_()`` of
    the gathers' ``[B, W]`` f32 output, which writes its bytes and nothing
    else.  Median and mean of 20, as check_kernel times a kernel."""
    import statistics
    import torch
    from envidr_tpu_torch.ops import _cuda, gather
    from envidr_tpu_torch.tools._timing import cuda_times

    dev = torch.device("cuda")
    out = torch.empty((BENCH["B"], BENCH["W"]), device=dev)
    before = gather.EMPTY.launches
    times = {name: cuda_times(fn, 20, 3) for name, fn in (
        ("empty_launch", lambda: _cuda.launch(gather.EMPTY, "empty", dev, 0, 0, 0, 0, 0)),
        ("zero_out", out.zero_))}
    if gather.EMPTY.launches != before + 23:
        raise AssertionError("the empty kernel did not go through the launch path")
    readings = {**{f"{k}_ms": statistics.median(t) * 1e3 for k, t in times.items()},
                **{f"{k}_mean_ms": statistics.fmean(t) * 1e3 for k, t in times.items()}}
    phase("kernels", "floor", **readings)


def check_bench_kernels():
    """Rows 2-8, each kernel at the micro-benchmarks' shapes."""
    import torch
    from envidr_tpu_torch.ops import gather, scatter

    B, W, S, Ss = BENCH["B"], BENCH["W"], BENCH["S"], BENCH["S_small"]
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, S, (B,), device="cuda", generator=g, dtype=torch.int32)
    rows = torch.randn(B, W, device="cuda", generator=g)
    table = torch.randn(S, W, device="cuda", generator=g)
    idx_s = idx % Ss
    table_s = table[:Ss].contiguous()
    gsrc = "envidr_tpu_torch/csrc/gather_rows.cu"
    ssrc = "envidr_tpu_torch/csrc/scatter_rows.cu"
    bf16, f32 = torch.bfloat16, torch.float32

    def gather_bytes(i):        # index, the distinct rows it touches, output
        return B * 4 + torch.unique(i).numel() * W * 4 + B * W * 4

    def scatter_bytes(s):       # index, rows, output
        return B * 4 + B * W * 4 + s * W * 4

    def index_add(i, s):
        return ("index_add_", lambda: torch.zeros((s, W), device="cuda").index_add_(0, i, rows))

    def named(bench, name):     # one micro-benchmark row, by its exact name
        return (bench, re.escape(name))

    out = []
    for row, line, name in (("2", 182, f"pallas take (VMEM table S={Ss})"),
                            ("3", 209, f"pallas take_along_axis (S={Ss})")):
        out.append(check_kernel(
            row, "gather_rows<f32>", gsrc, f"tools/bench_scatter.py:{line}",
            f"table [{Ss},{W}] f32, idx [{B}]", lambda: gather.gather_rows(table_s, idx_s),
            lambda: gather.gather_rows_plain(table_s, idx_s),
            ("index_select", lambda: table_s.index_select(0, idx_s)),
            gather_bytes(idx_s), 0.0, named("bench_scatter", name)))
    out.append(check_kernel(
        "4", "gather_rows<round_bf16>", gsrc, "tools/bench_scatter.py:249",
        f"table [{S},{W}] f32, idx [{B}]", lambda: gather.gather_rows(table, idx, True),
        lambda: gather.gather_rows_plain(table, idx, True), None, gather_bytes(idx), 0.0,
        named("bench_scatter", "pallas one-hot MXU gather S=2^19")))
    out.append(check_kernel(
        "5", "scatter_add_rows<round_bf16>", ssrc, "tools/bench_scatter.py:287",
        f"idx [{B}], rows [{B},{W}] -> [{S},{W}]",
        lambda: scatter.scatter_add_rows(idx[None], rows[None], S, round_bf16=True),
        lambda: scatter.scatter_add_rows_plain(idx[None], rows[None], S, round_bf16=True),
        None, scatter_bytes(S), FEW_ROWS_ATOL,
        named("bench_scatter", "pallas one-hot MXU scatter S=2^19")))
    out.append(check_kernel(
        "6", "scatter_rows_tiled<f32>", ssrc, "tools/bench_scatter.py:324",
        f"idx [{B}], rows [{B},{W}] -> [{Ss},{W}]",
        lambda: scatter.scatter_rows_tiled(idx_s, rows, Ss),
        lambda: scatter.scatter_rows_tiled_plain(idx_s, rows, Ss),
        index_add(idx_s, Ss), scatter_bytes(Ss), SCATTER_ATOL,
        named("bench_scatter", f"pallas fori scatter (S={Ss} VMEM)")))
    for s_lvl in (4096, 32768, 131072):
        i = idx % s_lvl
        out.append(check_kernel(
            "7", "scatter_rows_tiled<f32>", ssrc, "tools/bench_scatter2.py:126",
            f"idx [{B}], rows [{B},{W}] -> [{s_lvl},{W}]",
            lambda: scatter.scatter_rows_tiled(i, rows, s_lvl),
            lambda: scatter.scatter_rows_tiled_plain(i, rows, s_lvl),
            index_add(i, s_lvl), scatter_bytes(s_lvl), SCATTER_ATOL,
            ("bench_scatter2", rf"pallas fori S={s_lvl} K=\d+ acc \(\d+MB\)")))
    for acc, name in ((f32, "scatter_rows_tiled<f32>"), (bf16, "scatter_rows_tiled<bf16>")):
        out.append(check_kernel(
            "8", name, ssrc, "tools/bench_gs4.py:51",
            f"idx [{B}], rows [{B},{W}] -> [{S},{W}], {str(acc)[6:]} accumulator",
            lambda: scatter.scatter_rows_tiled(idx, rows, S, acc),
            lambda: scatter.scatter_rows_tiled_plain(idx, rows, S, acc),
            index_add(idx, S) if acc == f32 else None, scatter_bytes(S),
            FEW_ROWS_ATOL if acc == f32
            else (lambda ref: BF16_ACC_RTOL * float(ref.abs().max())),
            ("bench_gs4", rf"tiled pallas n=\d+ K=\d+ {str(acc)[6:]} *\(\d+MB\)")))
    return out


def bf16_accumulator_readings():
    """Readings behind BF16_ACC_RTOL: scatter_rows_tiled<bf16> and its plain
    version (index_add_ into bf16, also atomic on the card) sum the same
    bf16-rounded rows in two orders; each against the other and against the
    f64 sum, at 0.5 rows a slot (row 8), 1 (the cuda-marked test) and 64 (a
    dense 4096-row level)."""
    import torch
    from envidr_tpu_torch.ops import scatter

    W = BENCH["W"]
    for S, B in ((BENCH["S"], BENCH["B"]), (8192, 8192), (4096, BENCH["B"])):
        g = torch.Generator(device="cuda").manual_seed(1)
        idx = torch.randint(0, S, (B,), device="cuda", generator=g, dtype=torch.int32)
        rows = torch.randn(B, W, device="cuda", generator=g)
        kern = scatter.scatter_rows_tiled(idx, rows, S, torch.bfloat16)
        plain = scatter.scatter_rows_tiled_plain(idx, rows, S, torch.bfloat16)
        exact = torch.zeros((S, W), dtype=torch.float64, device="cuda").index_add_(
            0, idx.long(), rows.to(torch.bfloat16).double())
        top = float(exact.abs().max())
        phase("kernels", "bf16 accumulator reading", S=S, B=B, rows_per_slot=B / S,
              max_abs_sum=top, kernel_vs_plain=float((kern - plain).abs().max()),
              kernel_vs_f64=float((kern.double() - exact).abs().max()),
              plain_vs_f64=float((plain.double() - exact).abs().max()),
              rtol_2_7=2.0**-7 * top, tol=BF16_ACC_RTOL * top)


def check_hash():
    """The hash encoder (forward, first and second order, the row indices)
    and the sorted scatter: card against CPU at a small size."""
    import torch
    from envidr_tpu_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec(num_levels=6, level_dim=2, base_resolution=8,
                           desired_resolution=2048, log2_hashmap_size=14, indexing="hash")
    gen = torch.Generator().manual_seed(5)
    emb = torch.rand(spec.table_size, 2, generator=gen) * 0.2 - 0.1
    x = torch.rand(4096, 3, generator=gen)
    proj = torch.randn(spec.output_dim, generator=gen)
    results = []
    for dev in ("cpu", "cuda"):
        e = emb.to(dev).requires_grad_(True)
        xx = x.to(dev).requires_grad_(True)
        out = hg.hash_encode(xx, e, spec)
        g1 = torch.autograd.grad((out ** 2).sum(), (e, xx))
        f = (hg.hash_encode(xx, e, spec) @ proj.to(dev)).sum()
        (gx,) = torch.autograd.grad(f, xx, create_graph=True)
        g2 = torch.autograd.grad(((gx.norm(dim=-1) - 1.0) ** 2).sum(), (e, xx))
        idx = hg.hash_grid_indices(spec, x.to(dev))
        results.append([t.detach().cpu() for t in (out, *g1, *g2, idx)])
    (o0, a0, b0, c0, d0, i0), (o1, a1, b1, c1, d1, i1) = results

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)

    errs = {"fwd": float((o0 - o1).abs().max()), "d_emb": rel(a0, a1), "d_x": rel(b0, b1),
            "eik_d_emb": rel(c0, c1), "eik_d_x": rel(d0, d1)}
    tols = {"fwd": HASH_FWD_ATOL, "d_emb": HASH_GRAD1_RTOL, "d_x": HASH_GRAD1_RTOL,
            "eik_d_emb": HASH_GRAD2_RTOL, "eik_d_x": HASH_GRAD2_RTOL}
    bad = [k for k in errs if not errs[k] <= tols[k]]
    if bad or not torch.equal(i0, i1):
        raise AssertionError(f"hash encoder card vs CPU: {errs} (tolerances {tols}), "
                             f"indices equal {torch.equal(i0, i1)}")
    sidx = torch.randint(0, 4096, (3, 5000), generator=gen)
    srows = torch.randn(3, 5000, 16, generator=gen) * 1e-2
    ref = hg._sorted_segment_rows(sidx, srows, 4096)
    got = hg._sorted_segment_rows(sidx.cuda(), srows.cuda(), 4096).cpu()
    errs["sorted"] = float((ref - got).abs().max())
    if not errs["sorted"] <= SORTED_ATOL:
        raise AssertionError(f"sorted scatter card vs CPU: {errs['sorted']} > {SORTED_ATOL}")
    return {**errs, "tolerances": tols, "sorted_tol": SORTED_ATOL, "indices_equal": True}


def _parity_step(device: str, dtype, custom_grad: str):
    """One small train-step loss, image and gradients, as f64 CPU tensors."""
    import torch
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad=custom_grad, num_levels=4,
                       log2_hashmap_size=12, desired_resolution=64, hidden_dim=16,
                       hidden_dim_color=16, hidden_dim_env=16)
    cfg = network_config(opt)
    gen = torch.Generator().manual_seed(3)
    rays_o = torch.randn(256, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 2.5])
    target = torch.rand(256, 3, generator=gen) * 0.6 - 0.3
    rays_d = torch.nn.functional.normalize(target - rays_o, dim=-1)
    gt = torch.rand(256, 3, generator=gen)
    alpha = (torch.rand(256, generator=gen) > 0.5).float()
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0)).to(dtype)
    tr = Trainer(opt, cfg, device=device, net=net)
    tr.grid = tr.grid._replace(bitfield=torch.ones_like(tr.grid.bitfield))
    args = [t.to(device, dtype) for t in (rays_o, rays_d, gt, torch.ones(256, 3), alpha)]
    loss, out, _ = tr.forward_loss(*args, K=32, sched=resolve(opt, 1, 0))
    loss.backward()
    return {"loss": loss.detach().double().cpu().reshape(1),
            "image": out["image"].detach().double().cpu(),
            **{n: p.grad.detach().double().cpu() for n, p in tr.net.named_parameters()}}


def check_parity():
    """One small train-step loss, image and gradients: the card (kernels)
    against the CPU (plain versions), both f32, gated by PARITY_RTOL; and, as
    a reading of the f32 step's own error, the CPU f32 step against an f64
    one (autograd's table gradient: the scatter takes f32 rows only).  Each
    reading is max |a - b| / max |b| per tensor."""
    import torch

    def rel(a, b):
        return {n: float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
                for n in b}

    cpu = _parity_step("cpu", torch.float32, "on")
    card = rel(_parity_step("cuda", torch.float32, "on"), cpu)
    f64 = rel(cpu, _parity_step("cpu", torch.float64, "off"))
    phase("parity", "card_f32_vs_cpu_f32", json.dumps(card))
    phase("parity", "cpu_f32_vs_cpu_f64", json.dumps(f64))
    worst = max(card, key=card.get)
    if not card[worst] <= PARITY_RTOL:
        raise AssertionError(f"card and CPU train steps disagree: {worst} "
                             f"{card[worst]} > {PARITY_RTOL}")
    return {"max_rel_err": card[worst], "worst": worst, "tolerance": PARITY_RTOL,
            "f32_vs_f64_max": max(f64.values()), "f32_vs_f64_worst": max(f64, key=f64.get)}


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
    from envidr_tpu_torch.tools import bench_gs4, bench_scatter, bench_scatter2, scatter_edges
    from envidr_tpu_torch.train.metrics import psnr
    from envidr_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", kind=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi))

    built = build_all()
    phase("build", **{k: "cached" if v is None else f"nvcc_s={v:.1f}"
                      for k, v in built.items()})

    opt = load_options(os.path.join(ROOT, "configs", "synth_spheres.ini"),
                       hash_scatter_impl="mixed", hash_custom_grad="on")
    cfg = network_config(opt)
    K0 = opt.early_stop_steps                        # the first epoch's budget
    rows = [check_scatter(cfg.hash_spec, B=opt.num_rays * K0, W=8 * cfg.level_dim)]
    launch_floor()
    rows += check_bench_kernels()
    bf16_accumulator_readings()
    edges = scatter_edges.run(log=lambda line: phase("kernels", "edge", line))
    phase("kernels", "edge shapes ok", checks=len(edges))
    libs = dict(kernel_libraries())

    par = check_parity()
    phase("parity", **par)
    phase("hash", **check_hash())

    t = time.perf_counter()
    train = SynthSpheres("train", scale=opt.scale)
    val = SynthSpheres("val", scale=opt.scale)
    data_s = time.perf_counter() - t
    trainer = Trainer(opt, cfg)
    for lib in libs.values():                        # main path starts here
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.update_extra_state()
    occupied = float(trainer.grid.bitfield.float().mean())
    losses, step_ms, sync_free = [], [], 0
    for i in range(TRAIN_STEPS):
        # a step that neither starts an epoch nor refreshes the grid must not
        # block the host: any synchronising call in it raises
        guard = not trainer.step_may_sync()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if guard else "default")
        try:
            m = trainer.train_step(train)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        sync_free += guard
        losses.append(float(m["loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"step {i + 1}: loss {losses[-1]}")
    ms_per_step = float(np.mean(step_ms[3:]))
    launches_train = libs["scatter_add_rows"].launches
    if launches_train < TRAIN_STEPS:
        raise AssertionError(f"scatter_add_rows launched {launches_train} times in "
                             f"{TRAIN_STEPS} steps; expected at least one per step")
    if int(trainer.notfinite) or sync_free < TRAIN_STEPS - 3:
        raise AssertionError(f"notfinite {int(trainer.notfinite)}, {sync_free} steps "
                             "checked for host syncs")
    phase("train", steps=TRAIN_STEPS, loss_1=losses[0], loss_20=losses[-1],
          notfinite=int(trainer.notfinite), mean_samples_per_ray=float(m["mean_count"]),
          K=m["K"], sync_free_steps=sync_free,
          ms_per_step_after_3=ms_per_step, rays_per_s=opt.num_rays / ms_per_step * 1e3,
          first_step_ms=step_ms[0], grid_occupied=occupied,
          scatter_launches=launches_train,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, data_gen_s=data_s)

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = trainer.render_image(val.poses[0], val.intrinsics, val.H, val.W)
    render_s = time.perf_counter() - t
    train_launches = {k: lib.launches for k, lib in libs.items()}   # main path ends here
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

    for lib in libs.values():                        # the benchmarks' path starts here
        lib.launches = 0
    summaries = {}
    for bench in (bench_scatter, bench_scatter2, bench_gs4):
        name = bench.__name__.rsplit(".", 1)[-1]
        summaries[name] = bench.main(
            ["--iters", str(BENCH_ITERS), "--e2e-iters", str(BENCH_ITERS)]
            if bench is bench_scatter else ["--iters", str(BENCH_ITERS)])
    # and ends here; each table row takes the launches of its own bench rows
    for row in rows:
        bench_rows = row.pop("bench_rows")
        if bench_rows is None:                       # row 1: the train path's count
            row["launches"] = train_launches[row["name"]]
            continue
        bench, pattern = bench_rows
        matched = [r for r in summaries[bench]["rows"] if re.fullmatch(pattern, r["name"])]
        row["launches"] = sum(r["launches"].get(libs[row["name"]].symbol, 0) for r in matched)
        if not row["launches"]:
            raise AssertionError(f"row {row['row']} ({row['shape']}): the {bench} rows "
                                 f"{[r['name'] for r in matched]} launched no {row['name']}")
    phase("bench", launches_by_row=repr(" ".join(f"{r['row']}:{r['launches']}" for r in rows)))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
