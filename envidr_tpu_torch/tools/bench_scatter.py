"""Micro-benchmark: hash-table gather/scatter strategies on the card.

Port of the JAX package's ``tools/bench_scatter.py`` with its row names, at
its shape by default: B = 262,144 sample rows (4096 rays x K = 64), L = 16
levels, blocked row width 8*C = 16 floats, S = 2^19 table rows per level,
a small dense level of 4096 rows.

- gathers and scatters (the script's XLA rows): each is its nearest single
  PyTorch call (``index_select``, ``gather``, ``index_add_``, ``scatter_add_``,
  ``torch.sort`` + ``index_add_``, ``torch.segment_reduce``, a bf16 matmul
  with a one-hot matrix);
- the Pallas rows (a)-(e) launch their hand-written counterparts:
  (a), (b) ``gather_rows``, (c) ``gather_rows(round_bf16=True)``,
  (d) ``scatter_add_rows(round_bf16=True)``, (e) ``scatter_rows_tiled``;
- end to end, ``hash_encode`` forward and ``grad(emb, x)`` for the
  ``rolled_tiled`` and ``hash`` indexings at full width.

Run on the card::

    python -m envidr_tpu_torch.tools.bench_scatter [--iters 10]
"""

from __future__ import annotations

import argparse
import sys

import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.ops.gather import gather_rows
from envidr_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode, init_hash_embeddings
from envidr_tpu_torch.ops.scatter import scatter_add_rows, scatter_rows_tiled
from envidr_tpu_torch.tools._timing import Bench, pow2_name

W = 16                         # row width: 8 corners x 2 features
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--e2e-iters", type=int, default=5)
    ap.add_argument("--B", type=int, default=262_144, help="sample rows per level")
    ap.add_argument("--S", type=int, default=1 << 19, help="table rows per level")
    ap.add_argument("--L", type=int, default=16, help="levels")
    ap.add_argument("--s-small", type=int, default=4096, help="small dense level")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    a = parse_args(argv)
    dev = resolve_device(device)
    B, S, L, Ss = a.B, a.S, a.L, a.s_small
    bench = Bench("bench_scatter", dev, a.iters)
    g = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, S, (B,), device=dev, generator=g, dtype=torch.int32)
    rows = torch.randn(B, W, device=dev, generator=g)
    table = torch.randn(S, W, device=dev, generator=g)
    idxL = torch.randint(0, S, (L, B), device=dev, generator=g, dtype=torch.int32)
    rowsL = torch.randn(L, B, W, device=dev, generator=g)
    tableL = torch.randn(L, S, W, device=dev, generator=g)
    i64, iL64 = idx.long(), idxL.long()
    flatL = (iL64 + torch.arange(L, device=dev)[:, None] * S).reshape(-1)
    table_s = table[:Ss].contiguous()
    idx_s = idx % Ss
    is64 = idx_s.long()
    s2 = pow2_name(S)

    # ---------------- gathers ----------------
    bench.run(f"gather take [B,{W}] f32", lambda: table.index_select(0, i64), B, B * W * 4)
    bench.run(f"gather take batched L={L}",
              lambda: torch.gather(tableL, 1, iL64[..., None].expand(-1, -1, W)),
              L * B, L * B * W * 4)
    bench.run(f"gather take [B,{W}] bf16",
              lambda: table.to(torch.bfloat16).index_select(0, i64), B, B * W * 2)
    cols = torch.arange(Ss, device=dev)

    def g_onehot():
        oh = (is64[:, None] == cols).to(torch.bfloat16)
        return oh @ table_s.to(torch.bfloat16)

    bench.run(f"gather one-hot matmul S={Ss}", g_onehot, B, B * W * 4)

    # ---------------- scatters ----------------
    def zeros(n, dtype=torch.float32):
        return torch.zeros((n, W), dtype=dtype, device=dev)

    bench.run("scatter at[].add f32", lambda: zeros(S).index_add_(0, i64, rows),
              B, B * W * 4)
    flat_rowsL = rowsL.reshape(-1, W)
    bench.run(f"scatter at[].add batched L={L}",
              lambda: zeros(L * S).index_add_(0, flatL, flat_rowsL), L * B, L * B * W * 4)
    bench.run("scatter at[].add bf16",
              lambda: zeros(S, torch.bfloat16).index_add_(0, i64, rows.to(torch.bfloat16)),
              B, B * W * 2)
    bench.run("segment_sum unsorted",
              lambda: zeros(S).scatter_add_(0, i64[:, None].expand(-1, W), rows),
              B, B * W * 4)

    def s_sorted():
        si, order = torch.sort(i64)
        return zeros(S).index_add_(0, si, rows[order])

    bench.run("argsort + sorted scatter", s_sorted, B, B * W * 4)

    def s_sort_only():
        si, order = torch.sort(i64)
        return si, rows[order]

    bench.run("  (argsort+permute alone)", s_sort_only, B, B * W * 4)

    def s_sorted_seg():
        si, order = torch.sort(i64)
        lengths = torch.bincount(si, minlength=S)
        return torch.segment_reduce(rows[order], "sum", lengths=lengths, unsafe=True)

    bench.run("argsort + sorted segment_sum", s_sorted_seg, B, B * W * 4)

    def s_onehot():
        oh = (is64[:, None] == cols).to(torch.bfloat16)
        return oh.T @ rows.to(torch.bfloat16)

    bench.run(f"scatter one-hot matmul S={Ss}", s_onehot, B, B * W * 4)

    # ------------- Pallas rows (a)-(e): hand-written kernels -------------
    bench.run(f"pallas take (VMEM table S={Ss})", lambda: gather_rows(table_s, idx_s),
              B, B * W * 4)
    bench.run(f"pallas take_along_axis (S={Ss})", lambda: gather_rows(table_s, idx_s),
              B, B * W * 4)
    bench.run(f"pallas one-hot MXU gather S={s2}",
              lambda: gather_rows(table, idx, round_bf16=True), B, B * W * 4)
    bench.run(f"pallas one-hot MXU scatter S={s2}",
              lambda: scatter_add_rows(idx[None], rows[None], S, round_bf16=True),
              B, B * W * 4)
    bench.run(f"pallas fori scatter (S={Ss} VMEM)",
              lambda: scatter_rows_tiled(idx_s, rows, Ss), B, B * W * 4)

    # ---------------- end-to-end hash encode fwd/bwd ----------------
    for indexing in ("rolled_tiled", "hash"):
        spec = HashGridSpec(num_levels=L, level_dim=2, base_resolution=16,
                            log2_hashmap_size=S.bit_length() - 1, desired_resolution=2048,
                            interpolation="smoothstep", indexing=indexing)
        emb = init_hash_embeddings(spec, generator=torch.Generator().manual_seed(SEED))
        emb = emb.to(dev)
        x = torch.rand(B, 3, device=dev, generator=g)

        def fwd():
            with torch.no_grad():
                return hash_encode(x, emb, spec)

        def bwd():
            e = emb.detach().requires_grad_(True)
            xx = x.detach().requires_grad_(True)
            loss = (hash_encode(xx, e, spec) ** 2).sum()
            return torch.autograd.grad(loss, (e, xx))

        bench.run(f"hash_encode fwd ({indexing})", fwd, L * B, L * B * W * 4, a.e2e_iters)
        bench.run(f"hash_encode grad(emb,x) ({indexing})", bwd, 2 * L * B,
                  2 * L * B * W * 4, a.e2e_iters)
    return bench.summary()


if __name__ == "__main__":
    main(sys.argv[1:])
