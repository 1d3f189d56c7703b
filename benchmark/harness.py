"""What every cell shares: finding its files by name, the card checks, the
records printed before the result, the trace reduction and the result line.

A cell ``<name>`` of ``BENCHMARK.json`` reads ``configs/<config>.json``
(the program's options, the stated precision, the source),
``workloads/<name>.json`` (the cell's own parameters) and
``traffic/<traffic>.json`` (the mix: its kind and parameters), and runs
``traffic/<kind>.py``.  Each per-layer metric is ``metrics/<metric>.py``,
whose ``read(run)`` returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)                       # the checkout
BANNED = ("jax", "jaxlib", "flax", "envidr_tpu")    # top-level module names, whole


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by its names."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    params: dict
    per_layer: List[dict]
    end_to_end: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def options(self) -> dict:
        """The configuration's options, with the batch of the traffic mix
        where it sets one (``num_rays``: rays a step)."""
        o = dict(self.config["options"])
        if "num_rays" in self.traffic:
            o["num_rays"] = self.traffic["num_rays"]
        return o


def find_cell(name: str) -> Cell:
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{entry['config']}.json")
    traffic = load_json(HERE, "traffic", f"{entry['traffic']}.json")
    params = load_json(HERE, "workloads", f"{name}.json")
    listed = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return Cell(name, entry, config, traffic, params, listed, e2e)


def banned_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def process_start() -> float:
    """Epoch seconds at which this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def smi() -> str:
    """The card's name, clocks and power, read by nvidia-smi."""
    q = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


# ------------------------------------------------------------------ trace

@dataclass
class Trace:
    """A profiled stretch: its wall time, the union of the device's busy
    intervals in it, device time by operation, and the idle gaps named by
    the harness's host range around them."""

    window_s: float
    busy_s: float
    device_events: List[tuple] = field(default_factory=list)   # (name, cat, t0_us, t1_us)
    gaps: List[tuple] = field(default_factory=list)            # (name, seconds)

    def device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, _, a, b in self.device_events:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.gaps, key=lambda g: -g[1])[:n]]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class HostRanges:
    """The harness's own host ranges (name, start, end in epoch
    microseconds, the clock of the profiler's chrome trace), recorded
    without the profiler's CPU activity, whose per-operator cost would
    slow the host and inflate the device's idle share."""

    def __init__(self):
        self.spans = []

    def __call__(self, name: str):
        ranges = self

        class _Span:
            def __enter__(self):
                self.t0 = time.time_ns() / 1e3

            def __exit__(self, *exc):
                ranges.spans.append((name, self.t0, time.time_ns() / 1e3))
        return _Span()


def profiled(fn) -> "Trace":
    """Run ``fn(ranges)`` under ``torch.profiler`` with the device's activity
    alone, then synchronise; reduce the chrome trace to a :class:`Trace`
    whose window is the host's wall time from the call to the end of the
    synchronisation.  ``fn`` labels its calls with ``with ranges(name):``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ranges = HostRanges()
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        w0 = time.time_ns() / 1e3
        fn(ranges)
        if cuda:
            torch.cuda.synchronize()
        w1 = time.time_ns() / 1e3
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return reduce_trace(trace, w0, w1, ranges.spans)


def reduce_trace(trace: dict, w0: float, w1: float, spans) -> Trace:
    """The chrome trace's device events -> :class:`Trace`: device intervals
    (their ``ts`` plus the trace's ``baseTimeNanoseconds``, in epoch
    microseconds) clipped to the window ``[w0, w1]``, their union, and the
    gaps between them, each named by the host span around its midpoint."""
    base = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
    dev = []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"]) + base
        a, b = max(a, w0), min(a + float(e["dur"]), w1)
        if b > a:
            dev.append((e["name"], e["cat"], a, b))
    dev.sort(key=lambda d: d[2])
    busy = []
    for _, _, a, b in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            name = next((n for n, h0, h1 in spans if h0 <= mid <= h1), "between_calls")
            gaps.append((name, (b - a) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device_events=dev, gaps=gaps)


# ------------------------------------------------------------------- result

@dataclass
class Outcome:
    """What a traffic kind hands back to ``run.py``."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]       # name -> {"value", "limit"}
    run: Any = None                            # what the per-layer readers read
    records: List[str] = field(default_factory=list)
    memory_peak_bytes: int = 0


def checks_of(limits: Dict[str, float], got: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number that a cell's ``limits`` name, beside its limit."""
    return {k: {"value": got[k], "limit": lim} for k, lim in limits.items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
