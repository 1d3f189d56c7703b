"""Edge shapes of the scatter and gather kernels, each against its plain
version.

    python3 -m envidr_tpu_torch.tools.scatter_edges

``scatter_rows_tiled`` (one level) and ``scatter_add_rows`` (several levels)
at the shapes where the kernel's indexing or its level-by-level zeroing
could go wrong: one slot taking every row (every atomic on one address),
rows that hit a narrow range (the rest of the output must come out zero),
fewer rows than the grid has threads, a table of odd size or of a few rows,
2048 rows a slot, no rows at all, levels of different sizes, row widths 4
and 8, int64 indices and a bf16 accumulator.  The padding rows of ``scatter_add_rows``
must stay exactly zero.  ``gather_rows`` (both instantiations) at no rows,
one row, row counts that are not a multiple of a warp's 32 or a block's 256,
row widths 4, 8, 12, 32 and 160 (the generic instantiation), int64 indices, every
index equal, indices reaching S - 1 and a 2^19-row table; a gather is exact.
On the CPU both sides are the plain version; the cases are still built and
run.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from envidr_tpu_torch.ops import gather, scatter

F32_ATOL = 1e-3                 # f32 sums of up to ~64 unit-normal rows a slot
                                # (~2,600 in the one-slot cases, |sum| ~ 50), added
                                # in another order: chip_smoke.py's SCATTER_ATOL
BF16_ACC_RTOL = 2.0**-5         # of max |sum|: bf16 sums of a few rows a slot (16 in
                                # the one-slot case) in two atomic orders
                                # (chip_smoke.py's BF16_ACC_RTOL)


class Case(NamedTuple):
    name: str
    kernel: str                    # "scatter_rows_tiled" | "scatter_add_rows" | "gather_rows"
    run: Callable[[], torch.Tensor]        # the kernel's output
    plain: Callable[[], torch.Tensor]
    atol: Optional[float]                  # None: BF16_ACC_RTOL of max |sum|
    padding: Optional[List[int]] = None    # scatter_add_rows: each level's size


def _tiled(name, S, B, W=16, idx=None, acc=torch.float32, idx_dtype=np.int32,
           seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S, B) if idx is None else idx
    i = torch.from_numpy(np.asarray(idx).astype(idx_dtype)).to(device)
    rows = torch.from_numpy(rng.standard_normal((B, W), dtype=np.float32)).to(device)
    return Case(name, "scatter_rows_tiled",
                lambda: scatter.scatter_rows_tiled(i, rows, S, acc),
                lambda: scatter.scatter_rows_tiled_plain(i, rows, S, acc),
                F32_ATOL if acc == torch.float32 else None)


def _levels(name, sizes, s_max, B, W=16, idx=None, round_bf16=False, idx_dtype=np.int32,
            seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    if idx is None:
        idx = np.stack([rng.integers(0, s, B) for s in sizes])
    i = torch.from_numpy(np.asarray(idx).astype(idx_dtype)).to(device)
    rows = torch.from_numpy(rng.standard_normal((len(sizes), B, W), dtype=np.float32)).to(device)
    return Case(name, "scatter_add_rows",
                lambda: scatter.scatter_add_rows(i, rows, s_max, round_bf16),
                lambda: scatter.scatter_add_rows_plain(i, rows, s_max, round_bf16),
                F32_ATOL, list(sizes))


# gather shapes: {name: overrides of S=4096, B=8192, W=16, indices drawn from
# [low, S) (default 0), int32, f32 output}; "same": every index S - 1
GATHER_CASES = {
    "gather, no rows": dict(B=0),
    "gather, one row": dict(B=1),
    "gather, 1000 rows (not a multiple of 32 or 256)": dict(B=1000),
    "gather, 100003 rows, 2^19-row table, round_bf16": dict(S=1 << 19, B=100_003,
                                                           round_bf16=True),
    "gather, W = 4": dict(W=4),
    "gather, W = 8, round_bf16": dict(W=8, round_bf16=True),
    "gather, W = 12": dict(W=12, B=8195),
    "gather, W = 32": dict(W=32, B=8200),
    "gather, W = 160 (more than 32 quarters a row)": dict(W=160, B=3000),
    "gather, int64 indices": dict(idx_dtype=np.int64),
    "gather, every index equal": dict(same=True),
    "gather, indices reaching S - 1": dict(S=100_003, low=100_003 - 100),
    "gather, 2^19-row table": dict(S=1 << 19, B=262_144),
    "gather, 2^19-row table, round_bf16": dict(S=1 << 19, B=262_144, round_bf16=True),
}


def gather_inputs(name: str, seed: int = 0):
    """(table [S, W] f32, idx [B], round_bf16) of one gather case, numpy."""
    c = {**dict(S=4096, B=8192, W=16, low=0, idx_dtype=np.int32, same=False,
                round_bf16=False), **GATHER_CASES[name]}
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((c["S"], c["W"]), dtype=np.float32)
    idx = rng.integers(c["low"], c["S"], c["B"])
    if c["same"]:
        idx[:] = c["S"] - 1
    elif c["B"]:
        idx[-1] = c["S"] - 1                  # the last table row is read
    return table, idx.astype(c["idx_dtype"]), c["round_bf16"]


def gather_case(name: str, device="cuda") -> Case:
    table, idx, rnd = gather_inputs(name)
    t, i = torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)
    return Case(name, "gather_rows", lambda: gather.gather_rows(t, i, rnd),
                lambda: gather.gather_rows_plain(t, i, rnd), 0.0)


def cases(device="cuda") -> List[Case]:
    S19, kw = 1 << 19, dict(device=device)
    return [
        _tiled("one slot takes every row", 4096, 2560, idx=np.full(2560, 7), **kw),
        _tiled("one slot takes every row, bf16", 4096, 16, idx=np.full(16, 7),
               acc=torch.bfloat16, **kw),
        _tiled("few rows, large table", S19, 500, **kw),
        _tiled("few rows, large table, bf16", S19, 500, acc=torch.bfloat16, **kw),
        _tiled("rows hit a narrow range", S19, 8192,
               idx=np.random.default_rng(1).integers(S19 // 2, S19 // 2 + 100, 8192), **kw),
        _tiled("rows hit a narrow range, bf16", S19, 8192, acc=torch.bfloat16,
               idx=np.random.default_rng(1).integers(S19 // 2, S19 // 2 + 8192, 8192), **kw),
        _tiled("odd table size", 100_003, 65536, **kw),
        _tiled("odd table size, bf16", 100_003, 65536, acc=torch.bfloat16, **kw),
        _tiled("table of 100 rows", 100, 6400, **kw),
        _tiled("W = 4", 8192, 8192, W=4, **kw),
        _tiled("W = 8", 8192, 8192, W=8, **kw),
        _tiled("W = 8, bf16", 8192, 8192, W=8, acc=torch.bfloat16, **kw),
        _tiled("int64 indices", 8192, 8192, idx_dtype=np.int64, **kw),
        _tiled("2048 rows a slot", 128, 262_144, **kw),
        _levels("one slot a level takes every row", [100, 5000, 70_000], 70_001, 2560,
                idx=np.array([[3] * 2560, [4999] * 2560, [0] * 2560]), **kw),
        _levels("few rows, levels of different sizes", [100, 5000, 1 << 18], 1 << 18, 300,
                **kw),
        _levels("levels of different sizes", [100, 5000, 1 << 18], 1 << 18, 10_000, **kw),
        _levels("levels of different sizes, W = 4", [100, 5000, 1 << 18], 1 << 18, 10_000,
                W=4, **kw),
        _levels("levels of different sizes, W = 8, int64", [100, 5000, 1 << 18], 1 << 18,
                10_000, W=8, idx_dtype=np.int64, **kw),
        _levels("no rows", [100, 5000], 5000, 0, **kw),
        _levels("round_bf16", [8192], 8192, 8192, round_bf16=True, **kw),
        *(gather_case(name, device) for name in GATHER_CASES),
    ]


def run(device="cuda", log: Callable[[str], None] = print) -> List[dict]:
    """Every case against its plain version; raises on the first
    disagreement, else returns one record per case."""
    out = []
    for c in cases(device):
        ref = c.plain()
        tol = c.atol if c.atol is not None else BF16_ACC_RTOL * float(ref.abs().max())
        got = c.run()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        pad = 0.0
        if c.padding:
            pad = max([float(got[l, s:].abs().max()) if s < got.shape[1] else 0.0
                       for l, s in enumerate(c.padding)])
        ok = got.shape == ref.shape and err <= tol and pad == 0.0
        rec = {"kernel": c.kernel, "case": c.name, "max_abs_err": err, "tol": tol,
               "padding_max": pad, "ok": ok}
        log(" ".join(f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}"
                     for k, v in rec.items()))
        if not ok:
            raise AssertionError(f"{c.kernel} {c.name!r} disagrees with its plain "
                                 f"version: {rec}")
        out.append(rec)
    return out


if __name__ == "__main__":
    run()
