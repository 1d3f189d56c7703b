"""Inputs of ``ops/cp_rows.py``'s kernels at the CP train step's shapes.

The benchmark's CP step (16,384 rays, K = 32 slots a ray, 4.1 samples a
ray) encodes N = 524,288 slots per table; 87% of them are empty and all
encode the point 0.5, so each table sees one row pair in runs of about 28.
:func:`step_indices` lays out that pattern: each ray's first 4 slots at
uniform rows, its other 28 at the row of 0.5.  The card's checks of the
kernels (``tests/test_torch_cp_rows.py``, ``chip_smoke.py``) use it at
three of the encoder's 16 table sizes: the smallest, a middle one and the
largest, the one that does not fit a block's shared memory.
"""

from __future__ import annotations

import torch

N = 524_288                      # 16,384 rays x K = 32
RANK = 32
ROWS = (16, 213, 2048)           # levels 0, 8 and 15 of CPSpec()
K, LIVE = 32, 4                  # slots a ray, live ones (the rest one run)


def step_indices(rows: int, n: int = N, generator=None, device="cpu") -> torch.Tensor:
    """``[n]`` int64 row indices in ``[0, rows - 2]``: per ray of K slots,
    LIVE uniform ones, then K - LIVE at the row of the point 0.5."""
    if n % K:
        raise ValueError(f"{n} slots are not whole rays of {K}")
    idx = torch.full((n // K, K), (rows - 1) // 2, dtype=torch.int64)
    idx[:, :LIVE] = torch.randint(0, rows - 1, (n // K, LIVE), generator=generator)
    return idx.reshape(-1).to(device)


def bytes_moved(n: int, rows: int, rank: int = RANK):
    """(gather, scatter) bytes at the least: the index and the 2 n rows once;
    the scatter's table written once.  The gather's table reads (at most
    the whole table, 0.2% of the rest at these shapes) are left out."""
    pair = n * 8 + 2 * n * rank * 4
    return pair, pair + rows * rank * 4
