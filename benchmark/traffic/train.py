"""Closed-loop scene training: one client calls ``Trainer.train_step`` back
to back on the sphere scene's train views, the mix's ``num_rays`` a step
(the configuration's where the mix sets none), the epoch's
view order and every ray draw from ``--seed``; the trainer refreshes its
occupancy grid every ``update_extra_interval`` steps as it schedules it.

Set-up builds one trainer, gives it its start (a checkpoint's parameters,
EMA and grid, or weights the benchmark makes from the seed), sets its draw
generator from the seed and takes the first ``compare_steps`` steps
through the window's own call, keeping what they produce: each step's
loss, the optimizer's first moments after step 1 (which give the clipped
first gradient, the moments starting at zero) and the parameters after the
last of them.  Then it trains on through ``setup_steps`` steps and the next
grid refresh, so that every shape the window uses has run.  The window
runs steps for ``--seconds`` and ends in a device synchronisation; CUDA
events recorded before each step give the step times.  Once it has closed,
the reference takes the same steps from the same start and draws, and the
two are compared leaf by leaf.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import ckpt, params as ref_params
from benchmark.reference import model as ref
from benchmark.scene import SceneSplit

B1 = 0.9        # Adam's first-moment decay: m after one step from zero is (1 - B1) g


def draw_seed(seed: int) -> int:
    return seed + 1


@dataclass
class Start:
    """Where both sides start: parameters and EMA (name -> float32 tensor),
    the occupancy grid, the step counters and the running sample count."""

    params: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    density: torch.Tensor
    bitfield: torch.Tensor
    iter_density: int
    global_step: int
    epoch: int
    mean_count: float
    mean_density: float = 0.0
    resumed: bool = False
    drawn: List[str] = field(default_factory=list)     # nets the seed gave a resumed start


def make_start(cell: harness.Cell, spec: ref.Spec, seed: int, device) -> Start:
    """A checkpoint's start keeps every net whose leaves it holds at the
    configuration's widths; a net it holds narrower (the env net of a
    checkpoint trained at another width) comes, whole, with its EMA, from
    the seed, as all weights do in a seeded start."""
    weights = ref_params.make(spec, seed, device)
    if cell.params["weights"] != "checkpoint":
        n = 128 ** 3
        return Start(weights, {k: v.clone() for k, v in weights.items()},
                     torch.zeros((1, n), device=device),
                     torch.zeros((1, n), dtype=torch.bool, device=device), 0, 0, 0, -1.0)
    raw = ckpt.read(harness.os.path.join(harness.ROOT, cell.params["checkpoint"]))
    dens, bits, mean_density, it = raw["grid"]
    params, ema = (ckpt.flat_params(raw[k]) for k in ("params", "ema"))
    drawn = sorted({k.split(".", 1)[0] for k, w in weights.items()
                    if k not in params or tuple(params[k].shape) != tuple(w.shape)})
    start = Start({}, {}, torch.from_numpy(np.asarray(dens, np.float32)).to(device),
                  torch.from_numpy(np.asarray(bits, bool)).to(device), int(it),
                  int(raw["global_step"]), int(raw["epoch"]), float(raw["mean_count"]),
                  float(mean_density), True, drawn)
    for k, w in weights.items():
        if k.split(".", 1)[0] in drawn:
            start.params[k], start.ema[k] = w, w.clone()
        else:
            start.params[k] = torch.from_numpy(params[k]).to(device)
            start.ema[k] = torch.from_numpy(ema[k]).to(device)
    return start


@dataclass
class Program:
    """The program's trainer, its scene and what its compared steps made."""

    trainer: object
    scene: SceneSplit
    losses: List[torch.Tensor] = field(default_factory=list)
    first_grads: Dict[str, torch.Tensor] = field(default_factory=dict)
    after: Dict[str, torch.Tensor] = field(default_factory=dict)


def build_program(cell: harness.Cell, seed: int, device, start: Start, options: dict,
                  size: int, scene: Optional[SceneSplit] = None) -> Program:
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.ops.grid import OccupancyGrid
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options("", seed=seed, **{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in options.items()})
    trainer = Trainer(opt, network_config(opt), device=device)
    for net, src in ((trainer.net, start.params), (trainer.ema_net, start.ema)):
        mine = dict(net.named_parameters())
        if set(mine) != set(src):
            raise RuntimeError(f"parameter names differ: {sorted(set(mine) ^ set(src))}")
        with torch.no_grad():
            for name, t in src.items():
                if tuple(mine[name].shape) != tuple(t.shape):
                    raise RuntimeError(f"{name}: {tuple(mine[name].shape)} != {tuple(t.shape)}")
                mine[name].copy_(t)
    if start.resumed:
        # what Trainer.load_checkpoint restores of a file without optimizer
        # state, from the benchmark's own reading of it
        trainer.epoch, trainer.global_step = start.epoch, start.global_step
        trainer.host_mean_count = start.mean_count
        trainer.mean_count = torch.tensor(start.mean_count, dtype=torch.float64, device=device)
        trainer.grid = OccupancyGrid(density=start.density.clone(),
                                     bitfield=start.bitfield.clone(),
                                     mean_density=torch.tensor(start.mean_density, device=device),
                                     iter_density=start.iter_density)
        trainer.optimizer.retime(start.global_step)
    trainer.generator.manual_seed(draw_seed(seed))
    return Program(trainer, scene or SceneSplit(cell.traffic["split"], options["scale"], size))


def compared_steps(prog: Program, n: int):
    """The first ``n`` steps through ``train_step``; keeps their losses, the
    first gradient (from the optimizer's moments after step 1) and the
    parameters after step ``n``."""
    tr = prog.trainer
    names = {id(p): name for name, p in tr.net.named_parameters()}
    for i in range(n):
        prog.losses.append(tr.train_step(prog.scene)["loss"])
        if i == 0:
            opt = tr.optimizer
            prog.first_grads = {names[id(p)]: (m / (1.0 - B1)).detach().cpu()
                                for p, m in zip(opt.params, opt.m)}
    prog.after = {name: p.detach().cpu().clone() for name, p in tr.net.named_parameters()}


def reference_steps(cell: harness.Cell, spec: ref.Spec, seed: int, start: Start, scene, n: int,
                    half_batch: bool = False):
    """The reference's ``n`` steps from ``start`` on the same draws:
    (losses, first gradients, parameters after step ``n``)."""
    dev = start.density.device
    st = ref.State(params={k: v.clone() for k, v in start.params.items()},
                   ema={k: v.clone() for k, v in start.ema.items()},
                   density=start.density.clone(), bitfield=start.bitfield.clone(),
                   iter_density=start.iter_density, global_step=start.global_step,
                   epoch=start.epoch, mean_count=start.mean_count,
                   generator=torch.Generator(device=dev).manual_seed(draw_seed(seed)), seed=seed,
                   sched_count=start.global_step)
    st.m = {k: torch.zeros_like(v) for k, v in st.params.items()}
    st.v = {k: torch.zeros_like(v) for k, v in st.params.items()}
    losses, first = [], {}
    for i in range(n):
        out = ref.train_step(spec, st, scene, half_batch=half_batch)
        losses.append(float(out["loss"]))
        if i == 0:
            first = {k: (m / (1.0 - B1)).cpu() for k, m in st.m.items()}
    return losses, first, {k: v.cpu() for k, v in st.params.items()}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def compare(prog_losses, prog_first, prog_after, ref_losses, ref_first, ref_after,
            params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The compared numbers, each the worst case:
      loss_gap    max over steps of |loss - ref| / |ref|;
      loss_gap_first  the same of the first step alone, taken from the same
                  start on the same draws before any update;
      grad_gap    max over leaves of | |g| - |g_ref| | / max(|g_ref|, median leaf's |g_ref|);
      change_gap  the same of the parameters' change after the steps, over
                  the leaves whose reference gradient is at least 1e-3 of
                  the median leaf's (leaves the gradient leaves at rounding
                  move under Adam by round-off alone).
    A cell's ``limits`` name the numbers it compares.  The detail beside them
    counts, leaf by leaf, the elements of the first gradient whose sign the
    two sides disagree on: Adam's first update moves each element by lr
    times its gradient's sign, so each such element ends step 1 two lr
    apart on the two sides, however small the gradient."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses))
    gp, gr = _norms(prog_first), _norms(ref_first)
    med_g = float(np.median(list(gr.values())))
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], med_g) for k in gr}
    cp = _norms({k: prog_after[k] - params0[k] for k in params0})
    cr = _norms({k: ref_after[k] - params0[k] for k in params0})
    kept = [k for k in cr if gr[k] >= 1e-3 * med_g]
    med_c = float(np.median([cr[k] for k in kept]))
    change = {k: abs(cp[k] - cr[k]) / max(cr[k], med_c) for k in kept}
    flips = {k: int((torch.sign(prog_first[k]) != torch.sign(ref_first[k])).sum())
             for k in ref_first}
    return {"loss_gap": loss_gap,
            "loss_gap_first": abs(prog_losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-30),
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}, {
        "loss_gaps": [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses)],
        "grad_leaf": max(grad, key=grad.get), "change_leaf": max(change, key=change.get),
        "left_out": sorted(set(cr) - set(kept)),
        "sign_flips": {k: n for k, n in flips.items() if n}}


def readings(cell: harness.Cell, seed: int, device, options: dict, size: int,
             variant: str = "program", scene: Optional[SceneSplit] = None) -> Dict[str, float]:
    """The compared numbers of one seed without a window: ``program`` (the
    program's steps), ``tf32`` (the reference at TF32 in its place) or
    ``half_batch`` (the reference with half the batch left out)."""
    spec = ref.Spec({**options, **cell.config["stated"]})
    start = make_start(cell, spec, seed, device)
    params0 = {k: v.cpu() for k, v in start.params.items()}
    n = cell.params["compare_steps"]
    scene = scene or SceneSplit(cell.traffic["split"], options["scale"], size)
    if variant == "program":
        prog = build_program(cell, seed, device, start, options, size, scene)
        compared_steps(prog, n)
        side = ([float(x) for x in prog.losses], prog.first_grads, prog.after)
        del prog
        _free()
    else:
        side = reference_steps(cell, ref.Spec(spec.options, precision=(
            "tf32" if variant == "tf32" else "float32")), seed, start, scene, n,
            half_batch=variant == "half_batch")
    ref_side = reference_steps(cell, spec, seed, start, scene, n)
    got, detail = compare(*side, *ref_side, params0)
    return {**got, **detail}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, *,
        options: Optional[dict] = None, size: int = 400,
        t_process: Optional[float] = None) -> harness.Outcome:
    """One run of the cell; ``options`` and ``size`` let the CPU tests make
    it smaller."""
    options = dict(cell.options() if options is None else options)
    p = cell.params
    spec = ref.Spec({**options, **cell.config["stated"]})
    start = make_start(cell, spec, seed, device)
    prog = build_program(cell, seed, device, start, options, size)
    tr = prog.trainer
    compared_steps(prog, p["compare_steps"])
    every = options["update_extra_interval"]
    steps = p["compare_steps"]
    while steps < p["setup_steps"] or (p["warm_through_refresh"]
                                       and tr.global_step % every != 1):
        tr.train_step(prog.scene)           # through the next grid refresh
        steps += 1

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    notfinite0 = tr.notfinite.clone()
    sync()
    t0 = time.perf_counter()
    setup_s = time.time() - (t_process if t_process is not None else time.time())
    records = [f"setup: {setup_s:.3f} s to the window; steps={steps} "
               f"global_step={tr.global_step} iter_density={tr.grid.iter_density} "
               "(>=16: quarter-slab refreshes)"
               + (f"; resumed at step {start.global_step}, from the seed: {start.drawn}"
                  if start.resumed else "")]
    events, host_ms, ks, counts, notfinite, refresh = [], [], [], [], [], []
    while True:
        ev = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
        if ev is not None:
            ev.record()
        events.append(ev)
        refresh.append(tr.global_step % every == 0)
        h = time.perf_counter()
        m = tr.train_step(prog.scene)
        host_ms.append((time.perf_counter() - h) * 1e3)
        ks.append(m["K"])
        counts.append(m["mean_count"])
        notfinite.append(m["notfinite"])
        if time.perf_counter() - t0 >= seconds:
            break
    end = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
    if end is not None:
        end.record()
    sync()
    wall = time.perf_counter() - t0
    n = len(host_ms)
    step_ms = ([events[i].elapsed_time((events + [end])[i + 1]) for i in range(n)]
               if end is not None else [])
    nf = torch.stack([notfinite0] + notfinite).tolist()
    failed = sum(1 for a, b in zip(nf[:-1], nf[1:]) if b > a)
    samples = float(torch.stack(counts).double().sum()) * options["num_rays"]
    window = SimpleNamespace(steps=n, wall_s=wall, step_ms=step_ms, host_ms=host_ms,
                             refresh=refresh, samples=samples)
    e2e = {"train_rays_per_s": n * options["num_rays"] / wall, "setup_s": setup_s}
    q = harness.percentile
    records.append(f"window: steps={n} wall_s={wall:.3f} host_ms p10/50/90="
                   f"{q(host_ms, 10):.2f}/{q(host_ms, 50):.2f}/{q(host_ms, 90):.2f}"
                   + (f" step_ms p10/50/90={q(step_ms, 10):.2f}/{q(step_ms, 50):.2f}/"
                      f"{q(step_ms, 90):.2f} refresh_steps={sum(refresh)} "
                      f"K={sorted(set(ks))}"
                      if step_ms else ""))
    if step_ms:
        e2e["train_step_ms_p95"] = harness.percentile(step_ms, 95.0)

    traced, trace_ks = None, []
    if trace:
        def traced_steps(ranges):
            for _ in range(p["trace_steps"]):
                name = "train_step_refresh" if tr.global_step % every == 0 else "train_step"
                with ranges(name):
                    trace_ks.append(tr.train_step(prog.scene)["K"])
        traced = harness.profiled(traced_steps)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if device.type == "cuda":
        from envidr_tpu_torch.ops._cuda import launch_counts
        records.append(f"launch_counts: {launch_counts()}")

    prog_side = ([float(x) for x in prog.losses], prog.first_grads, prog.after)
    scene = prog.scene
    del prog, tr, m
    _free()
    ref_side = reference_steps(cell, spec, seed, start, scene, p["compare_steps"])
    got, detail = compare(*prog_side, *ref_side, {k: v.cpu() for k, v in start.params.items()})
    records.append(f"check detail: {detail}")
    checks = harness.checks_of(p["limits"], got)
    run_ctx = SimpleNamespace(kind="train", cell=cell, options=options, window=window,
                              trace=traced, trace_ks=trace_ks)
    return harness.Outcome(e2e=e2e, attempted=n, failed=failed, checks=checks, run=run_ctx,
                           records=records, memory_peak_bytes=peak)
