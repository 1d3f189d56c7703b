"""The compared numbers of many seeds in one process, for setting a cell's
limits and showing that its controls fail them: the program's own
(``program``: the steps the timed path runs, without a window) and those
of the controls put in its place, the reference at TF32 (``tf32``) and the
reference with half of the batch left out of the loss (``half_batch``).
Each is judged against the cell's committed ``limits`` as a run judges
the program (``harness.is_correct``).

    python3 benchmark/control.py --workload cp_train --variant program --seeds 1,2,3

Prints one JSON line a seed, with ``correct``.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

VARIANTS = ("program", "tf32", "half_batch")


def judged(cell, seed: int, device, options: dict, size: int, variant: str,
           scene=None) -> dict:
    """The readings of ``variant`` on ``seed``, its checks against the
    cell's limits and whether they make it ``correct``."""
    from benchmark import harness

    kind = harness.load_module(os.path.join(HERE, "traffic", f"{cell.kind}.py"),
                               f"traffic_{cell.kind}")
    got = kind.readings(cell, seed, device, options, size, variant, scene=scene)
    checks = harness.checks_of(cell.params["limits"], got)
    return {**got, "checks": checks, "correct": harness.is_correct(checks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="program", choices=VARIANTS)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    from benchmark.scene import SceneSplit

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.find_cell(args.workload)
    options = cell.options()
    scene = SceneSplit(cell.traffic["split"], options["scale"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = judged(cell, seed, torch.device("cuda"), options, scene.H, args.variant, scene)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          **got, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
