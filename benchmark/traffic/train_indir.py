"""Closed-loop training of the interreflection model (``use_renv``: three
passes a step, ``renv_net``, the learned blend, frozen colour heads) on a
tracked NeRF-synthetic scene: one client calls ``Trainer.train_step`` back to
back, the mix's ``num_rays`` a step, the epoch's view order and every draw
(pixels, background, one march offset a pass) from ``--seed``; the trainer
refreshes its occupancy grid every ``update_extra_interval`` steps as it
schedules it.

It is ``train.py``'s kind on another scene and another reference, and reuses
``train.py``'s program side (``build_program``, ``compared_steps``) and
comparison (``compare``).  Its own:

  * the scene: ``scene_nerf.NerfScene`` of the cell's ``scene`` directory;
  * the start: ``train.make_start``'s rule (a checkpoint's nets at the
    configuration's widths; a net it holds narrower comes, whole, with its
    EMA, from the seed) with ``reference/params_indirect.py``'s leaves, and
    the grid cells that no train camera sees marked once
    (``reference/indirect.py:mark_untrained``), so that both sides march the
    same grid;
  * the reference: ``reference/indirect.py``'s step, in blocks of
    :data:`BLOCK_RAYS` rays;
  * the compared numbers: ``compare``'s over the trainable leaves, and two
    that show the mechanism live and the frozen heads frozen:
    ``renv_grad_zero`` (1 if ``renv_net`` took a gradient in the compared
    steps on one side and none on the other, read from whether its leaves
    moved, else 0) and ``frozen_moved`` (1 if a leaf of a frozen head, in
    the program's net or its EMA, changed over the compared steps, else 0).
    The renv gate opens where a reflected ray's opacity is above 0.9 and the
    surface's roughness below the threshold, on the order of one or two of
    8192 rays in this scene, and on none in some steps: then neither side's
    ``renv_net`` takes a gradient, and the check reads 0.

Set-up, window, trace and the result are ``train.py``'s.  After a traced
stretch the records also give the idle share of the device, the host syncs a
step and the program's counters over the traced steps.
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import ckpt, params_indirect
from benchmark.reference import indirect as ref
from benchmark.reference import model as M
from benchmark.scene import SceneSplit
from benchmark.scene_nerf import NerfScene

base = sys.modules.get("traffic_train") or harness.load_module(
    os.path.join(harness.HERE, "traffic", "train.py"), "traffic_train")
SIZE = 400          # the tracked scene's views
BLOCK_RAYS = 2048   # the reference's rays a block: its autograd graph fits beside the program's


def load_scene(cell: harness.Cell, options: dict, size: int = SIZE) -> NerfScene:
    return NerfScene(os.path.join(harness.ROOT, cell.params["scene"]), cell.traffic["split"],
                     options["scale"], downscale=max(1, SIZE // size))


def make_start(cell: harness.Cell, spec: M.Spec, seed: int, device, scene) -> "base.Start":
    """``train.make_start``'s rule with the interreflection model's leaves,
    then the cells that no camera of ``scene`` sees marked untrained."""
    weights = params_indirect.make(spec, seed, device)
    raw = ckpt.read(os.path.join(harness.ROOT, cell.params["checkpoint"]))
    dens, bits, mean_density, it = raw["grid"]
    params, ema = (ckpt.flat_params(raw[k]) for k in ("params", "ema"))
    drawn = sorted({k.split(".", 1)[0] for k, w in weights.items()
                    if k not in params or tuple(params[k].shape) != tuple(w.shape)})
    density = ref.mark_untrained(torch.from_numpy(np.asarray(dens, np.float32)).to(device),
                                 scene.poses, scene.intrinsics, spec["bound"])
    start = base.Start({}, {}, density, torch.from_numpy(np.asarray(bits, bool)).to(device),
                       int(it), int(raw["global_step"]), int(raw["epoch"]),
                       float(raw["mean_count"]), float(mean_density), True, drawn)
    for k, w in weights.items():
        if k.split(".", 1)[0] in drawn:
            start.params[k], start.ema[k] = w, w.clone()
        else:
            start.params[k] = torch.from_numpy(params[k]).to(device)
            start.ema[k] = torch.from_numpy(ema[k]).to(device)
    return start


def reference_steps(cell: harness.Cell, spec: M.Spec, seed: int, start, scene, n: int,
                    half_batch: bool = False):
    """The reference's ``n`` steps from ``start`` on the same draws:
    (losses, first gradients of the trainable leaves, parameters after step
    ``n``)."""
    dev = start.density.device
    st = M.State(params={k: v.clone() for k, v in start.params.items()},
                 ema={k: v.clone() for k, v in start.ema.items()},
                 density=start.density.clone(), bitfield=start.bitfield.clone(),
                 iter_density=start.iter_density, global_step=start.global_step,
                 epoch=start.epoch, mean_count=start.mean_count,
                 generator=torch.Generator(device=dev).manual_seed(base.draw_seed(seed)),
                 seed=seed, sched_count=start.global_step)
    names = ref.trainable(spec, st.params)
    st.m = {k: torch.zeros_like(st.params[k]) for k in names}
    st.v = {k: torch.zeros_like(st.params[k]) for k in names}
    losses, first = [], {}
    for i in range(n):
        out = ref.train_step(spec, st, scene, half_batch=half_batch,
                             block_rays=BLOCK_RAYS)
        losses.append(float(out["loss"]))
        del out
        if i == 0:
            first = {k: (m / (1.0 - base.B1)).cpu() for k, m in st.m.items()}
    return losses, first, {k: v.cpu() for k, v in st.params.items()}


def judge(spec: M.Spec, prog_side, ref_side, start, prog_frozen_moved: float):
    """(compared numbers, detail): ``train.compare`` over the trainable
    leaves, ``renv_grad_zero`` and ``frozen_moved``; the detail adds
    whether ``renv_net`` moved on each side (program, reference)."""
    names = ref.trainable(spec, start.params)
    losses, first, after = prog_side
    r_losses, r_first, r_after = ref_side
    params0 = {k: start.params[k].cpu() for k in names}
    got, detail = base.compare(losses, first, {k: after[k] for k in names}, r_losses, r_first,
                               {k: r_after[k] for k in names}, params0)

    def renv_moved(p):
        return any(not torch.equal(p[k], start.params[k].cpu()) for k in p
                   if k.startswith("renv_net."))
    moved = [renv_moved(after), renv_moved(r_after)]
    got["renv_grad_zero"] = float(moved[0] != moved[1])
    got["frozen_moved"] = prog_frozen_moved
    return got, {**detail, "renv_moved": moved}


def frozen_moved(spec: M.Spec, trainer, start) -> float:
    """1.0 if a leaf of a frozen module, in the net or its EMA, differs from
    the start, else 0.0."""
    frozen = ref.frozen_modules(spec)
    for net, src in ((trainer.net, start.params), (trainer.ema_net, start.ema)):
        for name, p in net.named_parameters():
            if name.split(".", 1)[0] in frozen and not torch.equal(p.detach(), src[name]):
                return 1.0
    return 0.0


def program_steps(cell, seed, device, start, options, size, scene, spec):
    """The program built from ``start`` and its compared steps: (program,
    its side for :func:`judge`, frozen_moved)."""
    prog = base.build_program(cell, seed, device, start, options, size, scene)
    base.compared_steps(prog, cell.params["compare_steps"])
    moved = frozen_moved(spec, prog.trainer, start)
    side = ([float(x) for x in prog.losses], prog.first_grads, prog.after)
    return prog, side, moved


def readings(cell: harness.Cell, seed: int, device, options: dict, size: int,
             variant: str = "program", scene=None) -> Dict[str, float]:
    """The compared numbers of one seed without a window: ``program``,
    ``tf32`` (the reference at TF32 in the program's place) or
    ``half_batch`` (the reference with half the batch left out).  A
    ``scene`` that is not this kind's (``control.py`` hands every kind the
    sphere scene) is not read."""
    spec = ref.make_spec({**options, **cell.config["stated"]})
    scene = (load_scene(cell, options, size) if scene is None or isinstance(scene, SceneSplit)
             else scene)
    start = make_start(cell, spec, seed, device, scene)
    n = cell.params["compare_steps"]
    if variant == "program":
        prog, side, moved = program_steps(cell, seed, device, start, options, size, scene, spec)
        del prog
        base._free()
    else:
        side = reference_steps(cell, ref.make_spec(spec.options, precision=(
            "tf32" if variant == "tf32" else "float32")), seed, start, scene, n,
            half_batch=variant == "half_batch")
        moved = 0.0
    ref_side = reference_steps(cell, spec, seed, start, scene, n)
    got, detail = judge(spec, side, ref_side, start, moved)
    return {**got, **detail}


def trace_records(run_ctx) -> list:
    """What a traced stretch shows beside the metrics: the device's idle
    share of the window, the host syncs a step and the program's counters."""
    from benchmark import readers, spans
    out = [f"idle_share_pct: {readers.idle_share_train(run_ctx)}",
           f"host_syncs_per_step: {spans.host_syncs_per_step(run_ctx)}"]
    found = spans._steps(run_ctx)
    if found is not None:
        snap, roots = found
        total: Dict[str, float] = {}
        for r in roots:
            for k, v in (snap.spans[r].counters or {}).items():
                if not k.startswith("launches."):
                    total[k] = total.get(k, 0) + v
        out.append(f"trace counters over {len(roots)} steps: {total}")
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device, *,
        options: Optional[dict] = None, size: int = SIZE,
        t_process: Optional[float] = None, scene=None) -> harness.Outcome:
    """One run of the cell; ``options``, ``size`` and ``scene`` let the CPU
    tests make it smaller."""
    options = dict(cell.options() if options is None else options)
    p = cell.params
    spec = ref.make_spec({**options, **cell.config["stated"]})
    scene = scene if scene is not None else load_scene(cell, options, size)
    start = make_start(cell, spec, seed, device, scene)
    prog, prog_side, moved = program_steps(cell, seed, device, start, options, size, scene, spec)
    tr = prog.trainer
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
               f"(>=16: quarter-slab refreshes); resumed at step {start.global_step}, "
               f"from the seed: {start.drawn}; indir_ref={tr._sched.indir_ref} "
               f"grad_rays={tr._sched.grad_rays}"]
    events, host_ms, ks, counts, notfinite, refresh, opened = [], [], [], [], [], [], []
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
        opened.append(m["renv_open"])
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
                      f"K={sorted(set(ks))}" if step_ms else "")
                   + f" renv_open_share_of_samples={float(torch.stack(opened).mean()):.3e}")
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
    run_ctx = SimpleNamespace(kind="train", cell=cell, options=options, window=window,
                              trace=traced, trace_ks=trace_ks)
    if trace:
        records += trace_records(run_ctx)

    del prog, tr, m
    base._free()
    ref_side = reference_steps(cell, spec, seed, start, scene, p["compare_steps"])
    got, detail = judge(spec, prog_side, ref_side, start, moved)
    records.append(f"check detail: {detail}")
    checks = harness.checks_of(p["limits"], got)
    return harness.Outcome(e2e=e2e, attempted=n, failed=failed, checks=checks, run=run_ctx,
                           records=records, memory_peak_bytes=peak)
