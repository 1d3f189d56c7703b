"""Data-parallel scaling probe of the train step: 1 and 2 ranks on one card.

Counterpart of ``tools/bench_scaling.py``, whose virtual CPU devices share
the host's cores.  Here the ranks are processes that share the one card
(``parallel/tiny_step.py``'s ``train`` worker under gloo), so the numbers
measure what the data-parallel step adds, not a speed-up:

  * ``gspmd_overhead_ratio``: t(step of ``2 * per_rank_rays`` rays on 2
    ranks) / t(the same rays on 1 rank);
  * ``weak_rays_per_sec_per_vdev``: rays/s per rank at ``per_rank_rays``
    rays a rank, for 1 and 2 ranks.

    python -m envidr_tpu_torch.tools.bench_scaling [--config INI] [--per-rank-rays N]

prints one JSON line.  Each time is the median of ``steps`` steps after a
grid refresh and 4 warm-up steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from envidr_tpu_torch.parallel.tiny_step import ROOT, run_group

DEFAULT_CONFIG = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
PER_RANK_RAYS = 2048
STEPS = 10


def measure(config: str = DEFAULT_CONFIG, *, per_rank_rays: int = PER_RANK_RAYS,
            steps: int = STEPS, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Three runs, each in fresh processes: 1 rank at ``per_rank_rays``, 1
    rank at twice that, 2 ranks at twice that.  A failed run raises."""
    def ms(world: int, rays: int):
        with tempfile.TemporaryDirectory() as out:
            ranks = run_group(world, "train", out, "--device", device, "--config", config,
                              "--rays", str(rays), "--steps", str(steps),
                              timeout=timeout)
        return float(ranks[0]["ms_per_step"]), ranks[0]["step_ms"]

    t1_weak, _ = ms(1, per_rank_rays)
    t1, reps1 = ms(1, 2 * per_rank_rays)
    t2, reps2 = ms(2, 2 * per_rank_rays)
    return {
        "gspmd_overhead_ratio": t2 / t1,
        "weak_rays_per_sec_per_vdev": {"1": per_rank_rays / t1_weak * 1e3,
                                       "2": per_rank_rays / t2 * 1e3},
        "t1_ms": t1, "t2_ms": t2, "t1_weak_ms": t1_weak,
        "rel_spread_2": float((reps2.max() - reps2.min()) / np.median(reps2)),
        "rel_spread_1": float((reps1.max() - reps1.min()) / np.median(reps1)),
        "per_rank_rays": per_rank_rays, "steps": steps, "config": os.path.basename(config),
        "ranks_share_one_card": True,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--per-rank-rays", type=int, default=PER_RANK_RAYS)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.config, per_rank_rays=args.per_rank_rays, steps=args.steps,
                             device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
