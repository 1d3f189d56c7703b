"""Where the scene train step's time goes on the card, by the step's own spans.

    python3 -m envidr_tpu_torch.train.profile_step [--config INI] [--steps 5] [--out FILE]

Builds the full-width trainer of ``--config`` (default
``configs/synth_spheres_cp.ini``, the repo's main path; a hash-grid config
takes the kernel path, ``config.card_options``), takes warm-up steps, times
``--steps`` steps, then traces as many with ``torch.profiler``, which turns
the program's spans on (``obs.py``).  Prints the wall time per step with the
profiler off and on, the device busy time per step (the device time of the
operators' kernels, memsets and copies, as the profiler's own "Self CUDA time
total" counts it; one stream, so nothing overlaps) and its share of the
untraced wall time, the peak memory, the operators that take the most device
time, and the CP encoder's row pair (``cp_rows.scatter``, the table
gradients, and ``cp_rows.gather``) by table size (:func:`cp_rows_table`).
Then, from the profiled steps' own spans (:func:`span_table`): for
each span, by its path from ``train_step``, the count, host ms, device ms
and self device ms a step; the share of ``train_step``'s device time that its
children cover; the counters a step; and the ten longest device idle gaps,
each named by the innermost span open at its midpoint on the trace's clock.
``--out FILE`` also writes the report to ``FILE`` and the profiler's chrome
trace, with the spans added as ``"X"`` events on a track of their own, to
``FILE`` less its suffix plus ``.trace.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Sequence, Tuple

import torch
from torch.autograd.profiler_util import EventList

from envidr_tpu_torch import obs
from envidr_tpu_torch.config import card_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.train.trainer import Trainer

WARMUP = 5
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PID = 1 << 20              # the spans' track in the chrome trace


def span_table(snap: obs.Snapshot) -> str:
    """Each span path of the recording's ``train_step`` roots a step: count,
    host ms, device ms and self device ms ("-" without a card); the least
    share of a step's device ms that its children cover; the counters a
    step."""
    roots = snap.roots("train_step")
    if not roots:
        return "spans: none recorded\n"
    n = len(roots)
    rows = {}
    for i, s in enumerate(snap.spans):
        if s.t1_ns is None or snap.spans[s.root].name != "train_step":
            continue
        r = rows.setdefault("/".join(snap.path(i)), [0, 0.0, None, None])
        r[0] += 1
        r[1] += s.host_ms
        if s.device_ms is not None:
            r[2] = (r[2] or 0.0) + s.device_ms
            r[3] = (r[3] or 0.0) + s.self_device_ms
    fmt = lambda v: "-" if v is None else f"{v / n:.3f}"   # noqa: E731
    out = [f"spans a step ({n} steps): count host_ms device_ms self_device_ms"]
    out += [f"  {p:<48} {r[0] / n:6.2f} {r[1] / n:9.3f} {fmt(r[2]):>9} {fmt(r[3]):>9}"
            for p, r in rows.items()]
    shares = [1.0 - snap.spans[r].self_device_ms / snap.spans[r].device_ms for r in roots
              if snap.spans[r].device_ms]
    if shares:
        out.append(f"children_share_of_train_step_device_ms: min {min(shares):.4f} "
                   f"max {max(shares):.4f}")
    out.append("counters a step: " + " ".join(
        f"{k}={v / n:g}" for k, v in sorted(snap.counters.items())))
    if snap.dropped:
        out.append(f"spans dropped: {snap.dropped}")
    return "\n".join(out) + "\n"


def cp_rows_table(snap: obs.Snapshot) -> str:
    """The ``cp_rows.scatter`` and ``cp_rows.gather`` spans of the
    recording's ``train_step`` roots by their tag, the table's rows: calls
    and device ms a step ("-" without a card)."""
    n = len(snap.roots("train_step"))
    rows = {}
    for s in snap.spans:
        if (s.name in ("cp_rows.scatter", "cp_rows.gather") and s.t1_ns is not None
                and snap.spans[s.root].name == "train_step"):
            r = rows.setdefault((s.name, s.tag), [0, None])
            r[0] += 1
            if s.device_ms is not None:
                r[1] = (r[1] or 0.0) + s.device_ms
    out = ["CP row pair by table rows (calls a step, device ms a step):"]
    out += [f"  {name:<16} rows={tag!s:<6} {r[0] / n:6.2f} "
            f"{'-' if r[1] is None else f'{r[1] / n:.3f}':>9}"
            for (name, tag), r in sorted(rows.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0))]
    return "\n".join(out) + "\n" if rows else "CP row pair: none recorded\n"


def trace_with_spans(trace: dict, snap: obs.Snapshot) -> dict:
    """The chrome trace with the recording's spans as ``"X"`` events (their
    device ms and step in ``args``) on a track of their own."""
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID,
               "args": {"name": "program spans"}}]
    for s in snap.spans:
        if s.t1_ns is not None:
            events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPAN_PID,
                           "tid": s.thread, "ts": (s.t0_ns - base_ns) / 1e3,
                           "dur": (s.t1_ns - s.t0_ns) / 1e3,
                           "args": {"step": s.step, "device_ms": s.device_ms,
                                    "tag": s.tag}})
    return {**trace, "traceEvents": trace["traceEvents"] + events}


def device_intervals(trace: dict):
    """The chrome trace's kernel, memcpy and memset intervals, epoch us."""
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    return [(float(e["ts"]) + base, float(e["ts"]) + base + float(e["dur"]))
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS]


def idle_gaps(busy: Sequence[Tuple[float, float]], w0_us: float, w1_us: float,
              spans: Sequence[obs.SpanRecord], n: int = 10) -> List[Tuple[str, float, float]]:
    """The ``n`` longest stretches of ``[w0_us, w1_us]`` (epoch us) that no
    interval of ``busy`` (device intervals, epoch us) covers, longest first,
    as (name, start us, ms): each named by the innermost span open at its
    midpoint on the host clock, or ``between_spans``."""
    merged: List[List[float]] = []
    for a, b in sorted((max(a, w0_us), min(b, w1_us)) for a, b in busy):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0_us] + [x for iv in merged for x in iv] + [w1_us]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  key=lambda g: g[0] - g[1])[:n]
    named = []
    for a, b in gaps:
        mid_ns = 0.5 * (a + b) * 1e3
        open_ = [s for s in spans if s.t1_ns is not None and s.t0_ns <= mid_ns <= s.t1_ns]
        name = max(open_, key=lambda s: (s.depth, s.t0_ns)).name if open_ else "between_spans"
        named.append((name, a, (b - a) / 1e3))
    return named


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
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.time_ns() / 1e3
        t = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
        w1 = time.time_ns() / 1e3
    snap = obs.snapshot()
    events = prof.key_averages()
    # operator events carry their kernels' device time; kernel rows and user
    # annotations (the spans among them) would count it twice
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and not e.is_user_annotation) / 1e3 / args.steps
    head = (f"device: {torch.cuda.get_device_name(0)}\n"
            f"config: {os.path.basename(args.config)}\n"
            f"steps: {args.steps} after {WARMUP} warm-up, K={trainer._K}, "
            f"rays={opt.num_rays}\n"
            f"peak_mem_gib: {torch.cuda.max_memory_allocated() / 2**30:.3f}\n"
            f"wall_ms_per_step: {plain_wall_ms:.3f} (profiler off), "
            f"{wall_ms:.3f} (profiler and spans on)\n"
            f"device_busy_ms_per_step: {busy_ms:.3f} "
            f"busy_share_of_unprofiled_wall: {busy_ms / plain_wall_ms:.3f}\n")
    # the spans' own rows (their host and device ranges) stay out of the
    # operators' table: the span table below gives them
    names = {s.name for s in snap.spans}
    ops = EventList([e for e in events if not e.is_user_annotation and e.key not in names],
                    use_device="cuda")
    table = ops.table(sort_by="self_device_time_total", row_limit=30)
    table += "\n" + cp_rows_table(snap) + span_table(snap)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    gaps = idle_gaps(device_intervals(trace), w0, w1, snap.spans)
    table += "longest device idle gaps (innermost span at the midpoint, ms):\n"
    table += "".join(f"  {name:<20} {ms:.4f}\n" for name, _, ms in gaps)
    print(head + table, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(head + table)
        with open(os.path.splitext(args.out)[0] + ".trace.json", "w") as f:
            json.dump(trace_with_spans(trace, snap), f)


if __name__ == "__main__":
    main()
