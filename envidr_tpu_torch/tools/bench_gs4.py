"""Micro-benchmark: the S-tiled scatter for tables larger than on-chip memory.

Port of the JAX package's ``tools/bench_gs4.py`` (a) with its row names, at
its shape by default (B = 262,144, S = 2^19, W = 16): the XLA anchor (one
``index_add_``, timed twice) and the Pallas ``make_tiled`` configs
``(n_tiles, K, accumulator)`` that pass the script's 13 MB filter, each row
launching ``scatter_rows_tiled``.  ``n_tiles`` and ``K`` are TPU tiling and
name the row only; the accumulator type (f32 or bf16) is the one parameter
that changes the result.  Mosaic never compiled ``make_tiled`` on the TPU.

Run on the card::

    python -m envidr_tpu_torch.tools.bench_gs4 [--iters 10]
"""

from __future__ import annotations

import argparse
import sys

import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.ops.scatter import scatter_rows_tiled
from envidr_tpu_torch.tools._timing import Bench, pow2_name

W = 16                         # row width: 8 corners x 2 features
SEED = 0

CONFIGS = ((8, 2, torch.float32), (8, 4, torch.float32), (4, 2, torch.bfloat16),
           (2, 1, torch.bfloat16))
FILTER_MB = 13                 # the script's filter on K * TILE * W * bytes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--B", type=int, default=262_144)
    ap.add_argument("--S", type=int, default=1 << 19)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    a = parse_args(argv)
    dev = resolve_device(device)
    B, S = a.B, a.S
    bench = Bench("bench_gs4", dev, a.iters)
    g = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
    rows = torch.randn(B, W, device=dev, generator=g)
    i64 = idx.long()
    s2 = pow2_name(S)

    def xla():
        return torch.zeros((S, W), device=dev).index_add_(0, i64, rows)

    bench.run(f"XLA scatter S={s2} (1 level)", xla, B, B * W * 4)
    bench.run(f"XLA scatter S={s2} (re-run)", xla, B, B * W * 4)
    for n_tiles, K, dt in CONFIGS:
        nbytes = 2 if dt == torch.bfloat16 else 4
        mb = K * (S // n_tiles) * W * nbytes / 1e6
        if mb > FILTER_MB:
            continue
        name = str(dt).removeprefix("torch.")
        bench.run(f"tiled pallas n={n_tiles} K={K} {name:8s} ({mb:.0f}MB)",
                  lambda: scatter_rows_tiled(idx, rows, S, acc_dtype=dt), B, B * W * 4,
                  iters=max(1, a.iters // 2))
    return bench.summary()


if __name__ == "__main__":
    main(sys.argv[1:])
