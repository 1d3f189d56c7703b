"""Inputs of ``ops/cp_rows.py``'s kernels at the CP train step's shapes.

The benchmark's CP step (16,384 rays, K = 32 slots a ray) fills 13.22% of
its slots: 69,311 samples.  Its render packs them (``ops/marching.py:
SlotPacking``) into one batch of 69,632 rows, a multiple of 4096: the
samples ray after ray, then 321 padding rows at the point 0, which the
encoder reads at the point 0.5.  So each table sees N = 69,632 points,
nearly all at rows of their own, and one run of 321 at the row of 0.5.
:func:`step_indices` lays out that pattern, the samples at uniform rows.
The card's checks of the kernels (``tests/test_torch_cp_rows.py``,
``chip_smoke.py``) use it at three of the encoder's 16 table sizes: the
smallest, a middle one and the largest, the one that does not fit a
block's shared memory.
"""

from __future__ import annotations

import torch

PACK_ROWS = 4096                 # ops/marching.py's: a packed batch is a multiple of this
FILLED = 69_311                  # 16,384 rays x 32 slots x 13.22% filled
N = -(-FILLED // PACK_ROWS) * PACK_ROWS      # 69,632 packed rows
RANK = 32
ROWS = (16, 213, 2048)           # levels 0, 8 and 15 of CPSpec()


def step_indices(rows: int, n: int = N, filled: int = FILLED, generator=None,
                 device="cpu") -> torch.Tensor:
    """``[n]`` int64 row indices in ``[0, rows - 2]``: ``filled`` uniform
    ones (the samples), then ``n - filled`` at the row of the point 0.5
    (the padding)."""
    if not 0 <= filled <= n:
        raise ValueError(f"{filled} samples do not fit {n} rows")
    idx = torch.full((n,), (rows - 1) // 2, dtype=torch.int64)
    idx[:filled] = torch.randint(0, rows - 1, (filled,), generator=generator)
    return idx.to(device)


def bytes_moved(n: int, rows: int, rank: int = RANK):
    """(gather, scatter) bytes at the least: the index and the 2 n rows once;
    the scatter's table written once.  The gather's table reads (at most
    the whole table, 1.5% of the rest at these shapes) are left out."""
    pair = n * 8 + 2 * n * rank * 4
    return pair, pair + rows * rank * 4
