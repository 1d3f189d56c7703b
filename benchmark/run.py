"""Run one cell of the port's benchmark on the card it is started on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the window again, then a profiled stretch after it).
Records (the card, its clocks and power limit, peak memory, kernel launch
counts) go to standard error before the result; the numbers that decide
``correct`` are its last lines there and the last key of the result, the
one JSON line that ends standard output.  Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# one host thread for CPU-side tensor work: the port computes on the card, and
# OpenMP workers beside the launching thread widened the spread between runs
# on the card's 8-core host
os.environ.setdefault("OMP_NUM_THREADS", "1")
# caches of the program's builds, at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, ".bench_cache", sub))


def result_line(cell, outcome, trace: bool, device_info: dict) -> dict:
    from benchmark import harness

    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = harness.load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                         "metric_" + m["name"].replace(".", "_"))
            value = reader.read(outcome.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            # a cell's metric may carry a suffix of its own: train_rays_per_s.cp
            value = outcome.e2e.get(m["name"], outcome.e2e.get(m["name"].split(".", 1)[0]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": harness.is_correct(outcome.checks), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device_info}
    tr = outcome.run.trace if trace else None
    if tr is not None:
        line["device"] = {**device_info, "busy_s": tr.busy_s, "window_s": tr.window_s}
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = outcome.checks
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, *, device=None, **test_kw):
    """One run; returns (result dict, records).  ``device`` and ``test_kw``
    let the CPU tests drive a run without a card, at a smaller size."""
    from benchmark import harness

    t_process = harness.process_start()
    cell = harness.find_cell(workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            print(f"run.py: {workload} needs {cell.entry['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False      # the stated float32
        torch.backends.cudnn.allow_tf32 = False
    kind = harness.load_module(os.path.join(HERE, "traffic", f"{cell.kind}.py"),
                               f"traffic_{cell.kind}")
    records = []
    if device.type == "cuda":
        records.append(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {harness.smi()}")
    outcome = kind.run(cell, seed, seconds, trace, device, t_process=t_process, **test_kw)
    records += outcome.records
    records.append(f"memory_peak_bytes: {outcome.memory_peak_bytes}")
    if device.type == "cuda":
        records.append(f"card after: {harness.smi()}")
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
            "count": cell.entry["chips"], "memory_peak_bytes": outcome.memory_peak_bytes}
    return result_line(cell, outcome, trace, info), records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness

    line, records = run(args.workload, args.seed, args.seconds, bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        print(f"run.py: the process loaded {banned}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for r in records:
        print(r, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
