"""Timing, row lines and the JSON summary of the micro-benchmarks."""

from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Dict, List

import torch

from envidr_tpu_torch.ops._cuda import launch_counts

# Larger than the H100's 50 MB L2: zeroing it between launches evicts the
# previous launch's inputs and outputs, so each timed launch reads from HBM
L2_FLUSH_BYTES = 256 * 2**20


def cuda_times(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> List[float]:
    """Seconds of each of ``iters`` calls of ``fn`` on the current CUDA device
    after ``warmup``: CUDA events around each call, with a 256 MiB buffer
    zeroed between calls (outside the events) to flush L2."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) / 1e3 for s, e in events]


def cuda_time(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """The median of :func:`cuda_times` (a host stall in one call would move
    a mean of 20 by its twentieth)."""
    return statistics.median(cuda_times(fn, iters, warmup))


def host_time(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of ``fn`` on the host clock (CPU tensors)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


class Bench:
    """The rows of one micro-benchmark run on one device."""

    def __init__(self, name: str, device: torch.device, iters: int, warmup: int = 2):
        self.name, self.device = name, device
        self.iters, self.warmup = iters, warmup
        self.rows: List[Dict[str, float]] = []
        self._time = cuda_time if device.type == "cuda" else host_time
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(f"{name}: device {device.type} ({kind}), {iters} timed calls after "
              f"{warmup} warm-up, "
              + ("CUDA events, L2 flushed between calls" if device.type == "cuda"
                 else "host clock"), flush=True)
        self.kind = kind

    def time(self, fn: Callable[[], object], iters: int = None) -> float:
        return self._time(fn, self.iters if iters is None else iters, self.warmup)

    def report(self, name: str, t: float, rows: float, nbytes: float,
               launches: Dict[str, int] = None) -> None:
        """One row: ``name  ms  Mrows/s  GB/s`` (the TPU scripts' format);
        ``launches`` (``{launcher: count}``) goes into the summary only."""
        self.rows.append({"name": name, "ms": t * 1e3, "mrows_per_s": rows / t / 1e6,
                          "gb_per_s": nbytes / t / 1e9, "launches": launches or {}})
        print(f"{name:52s} {t * 1e3:10.4f} ms {rows / t / 1e6:10.1f} Mrows/s "
              f"{nbytes / t / 1e9:8.2f} GB/s", flush=True)

    def run(self, name: str, fn: Callable[[], object], rows: float, nbytes: float,
            iters: int = None) -> None:
        """Time ``fn`` and report it with the kernel launches it made."""
        before = launch_counts()
        t = self.time(fn, iters)
        launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                    if n != before.get(k, 0)}
        self.report(name, t, rows, nbytes, launches)

    def summary(self) -> dict:
        """Print (after the bench's name) and return the JSON summary of
        every row."""
        out = {"bench": self.name, "device": {"type": self.device.type, "kind": self.kind},
               "timer": "cuda_events_l2_flushed" if self.device.type == "cuda" else "host",
               "rows": self.rows}
        print(f"{self.name} summary: {json.dumps(out)}", flush=True)
        return out


def pow2_name(n: int) -> str:
    """``2^19`` for a power of two, else the number (row names)."""
    return f"2^{n.bit_length() - 1}" if n > 0 and n & (n - 1) == 0 else str(n)

