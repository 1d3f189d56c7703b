"""Micro-benchmark: the chunked, bf16 and multi-accumulator scatter
candidates on the card.

Port of the JAX package's ``tools/bench_scatter2.py`` with its row names, at
its shape by default (B = 262,144, S = 2^19, W = 16, L = 16):

- A/B: the batched scatter with the batch cut into G chunks per level (L*G
  partial tables summed afterwards), in f32 (G = 1, 2, 4) and bf16
  (G = 1, 2, 4, 8): one ``index_add_`` into the ``[L*G*S, W]`` partials, then
  the sum over G;
- D: the batched gather from an f32 and a bf16 table (``torch.gather``);
- C: the Pallas multi-accumulator scatter (``make_pallas_multi``) for the
  script's ``(S_lvl, K)`` list and its 14 MB VMEM filter, each row launching
  ``scatter_rows_tiled``; K is TPU tiling and names the row only.

Run on the card::

    python -m envidr_tpu_torch.tools.bench_scatter2 [--iters 10]
"""

from __future__ import annotations

import argparse
import sys

import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.ops.scatter import scatter_rows_tiled
from envidr_tpu_torch.tools._timing import Bench

W = 16                         # row width: 8 corners x 2 features
SEED = 0

MULTI = ((4096, (1, 2, 4, 8)), (32768, (1, 2, 4)), (131072, (1, 2)))
VMEM_MB = 14                   # the script's filter on K * S_lvl * W * 4 bytes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--B", type=int, default=262_144)
    ap.add_argument("--S", type=int, default=1 << 19)
    ap.add_argument("--L", type=int, default=16)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    a = parse_args(argv)
    dev = resolve_device(device)
    B, S, L = a.B, a.S, a.L
    bench = Bench("bench_scatter2", dev, a.iters)
    g = torch.Generator(device=dev).manual_seed(SEED)
    idxL = torch.randint(0, S, (L, B), device=dev, generator=g, dtype=torch.int32)
    rowsL = torch.randn(L, B, W, device=dev, generator=g)
    flat_rows = rowsL.reshape(-1, W)

    # ---------------- A: chunked-batch scatter ----------------
    def chunked(G, dtype):
        lanes = torch.arange(L * G, device=dev)[:, None] * S
        flat = (idxL.long().reshape(L * G, B // G) + lanes).reshape(-1)

        def f():
            part = torch.zeros((L * G * S, W), dtype=dtype, device=dev)
            part.index_add_(0, flat, flat_rows.to(dtype))
            return part.reshape(L, G, S, W).sum(dim=1).float()
        return f

    bench.run(f"scatter at[].add batched L={L} (anchor)", chunked(1, torch.float32),
              L * B, L * B * W * 4)
    for G in (2, 4):
        bench.run(f"chunked scatter G={G} f32 (L*G={L * G} lanes)",
                  chunked(G, torch.float32), L * B, L * B * W * 4)
    for G in (1, 2, 4, 8):
        bench.run(f"chunked scatter G={G} bf16", chunked(G, torch.bfloat16),
                  L * B, L * B * W * 2)

    # ---------------- D: batched bf16 gather ----------------
    tableL = torch.randn(L, S, W, device=dev, generator=g)
    tableL_bf = tableL.to(torch.bfloat16)
    index = idxL.long()[..., None].expand(-1, -1, W)
    bench.run(f"gather take batched L={L} f32 (anchor)",
              lambda: torch.gather(tableL, 1, index), L * B, L * B * W * 4)
    bench.run(f"gather take batched L={L} bf16",
              lambda: torch.gather(tableL_bf, 1, index), L * B, L * B * W * 2)
    del tableL, tableL_bf

    # ---------------- C: multi-accumulator scatter ----------------
    idx1, rows1 = idxL[0], rowsL[0]
    for S_lvl, Ks in MULTI:
        idx_s = idx1 % S_lvl
        for K in Ks:
            vmem_mb = K * S_lvl * W * 4 / 1e6
            if vmem_mb > VMEM_MB:
                continue
            bench.run(f"pallas fori S={S_lvl} K={K} acc ({vmem_mb:.0f}MB)",
                      lambda: scatter_rows_tiled(idx_s, rows1, S_lvl), B, B * W * 4,
                      iters=max(1, a.iters // 2))
    return bench.summary()


if __name__ == "__main__":
    main(sys.argv[1:])
