"""Scatter-add of hash-table gradient rows: CUDA kernels + plain versions.

:func:`scatter_add_rows` is the counterpart of
``envidr_tpu/ops/pallas_scatter.py:scatter_add_rows`` (the Pallas TPU kernel,
body ``_kernel`` :45-61).  One launcher call computes ``idx [L, B] i32 x
rows [L, B, W] f32 -> out [L, S_max, W] f32`` for all levels at once, as one
flat scatter into ``[L * S_max, W]``.

What bounds it on an H100: bytes.  It reads ``L*B*(4 + 4W)`` bytes and writes
``L*S_max*W*4``; at the train step's shape (L=16, B=262,144, W=16,
S_max=2^19) that is ~822 MB, ~0.25 ms at 3.35 TB/s.

The TPU sizing helpers (``fits_vmem``, ``_pick_K``) size VMEM accumulators
and have no counterpart here: under ``hash_scatter_impl='mixed'`` every level
takes this kernel.  With ``round_bf16`` the second entry point rounds each
row value to bf16 before the f32 add: the counterpart of
``tools/bench_scatter.py:287`` ``s_pallas_onehot``.

:func:`scatter_rows_tiled` is the one-level scatter ``[B] x [B, W] -> [S, W]``
with an f32 or a bf16 accumulator: the counterpart of the micro-benchmarks'
Pallas scatters ``tools/bench_scatter.py:324`` ``s_pallas_fori``,
``tools/bench_scatter2.py:126`` ``make_pallas_multi`` and
``tools/bench_gs4.py:51`` ``make_tiled`` (its name is theirs; the kernel does
not tile).  Bound: bytes, ``B*(4 + 4W)`` read and ``S*W*4`` written.

Every entry point is ``csrc/scatter_rows.cu``: the output zeroed level by
level just before one 16-byte vector atomic per quarter row adds into it.
A launcher call makes one memset and one kernel launch a level and counts
as one launch, inside a span of the entry point's name (``obs.py``).

Build and launch: ``ops/_cuda.py``.  A CUDA tensor always takes the kernel;
if the build or the launch fails the wrapper raises.  A CPU tensor takes the
plain version (:func:`scatter_add_rows_plain`, :func:`scatter_rows_tiled_plain`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from envidr_tpu_torch import obs
from envidr_tpu_torch.ops._cuda import CudaLibrary, launch, on_card

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "scatter_rows.cu"

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
KERNEL = CudaLibrary(SOURCE, "scatter_add_rows_launch", _ARGS)
KERNEL_BF16 = CudaLibrary(SOURCE, "scatter_add_rows_round_bf16_launch", _ARGS)
TILED = {torch.float32: CudaLibrary(SOURCE, "scatter_rows_tiled_f32_launch", _ARGS),
         torch.bfloat16: CudaLibrary(SOURCE, "scatter_rows_tiled_bf16_launch", _ARGS)}
_INT32_MAX = 2**31 - 1


def _launch_scatter(lib: CudaLibrary, name: str, idx: torch.Tensor, rows: torch.Tensor,
                    out: torch.Tensor, S: int):
    """Launch ``lib`` on ``idx [L, B]`` and ``rows [L, B, W]`` into ``out``."""
    L, B, W = rows.shape
    if W % 4:
        raise ValueError(f"{name}: row width {W} is not a multiple of 4 (16-byte atomics)")
    if B > _INT32_MAX or S > _INT32_MAX:
        raise ValueError(f"{name}: {B} rows into {S} slots exceeds 32-bit indices")
    idx = idx.to(torch.int32).contiguous()
    rows = rows.contiguous()
    with obs.span(name):
        launch(lib, name, rows.device, idx.data_ptr(), rows.data_ptr(), out.data_ptr(),
               L, B, S, W)
    return out


def _check(idx: torch.Tensor, rows: torch.Tensor, s_max: int):
    if idx.dim() != 2 or rows.dim() != 3 or rows.shape[:2] != idx.shape:
        raise ValueError(f"expected idx [L, B] and rows [L, B, W], got "
                         f"{tuple(idx.shape)} and {tuple(rows.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32, got {rows.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    if s_max <= 0:
        raise ValueError(f"s_max must be positive, got {s_max}")


def scatter_add_rows_plain(idx: torch.Tensor, rows: torch.Tensor,
                           s_max: int, round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` per level."""
    _check(idx, rows, s_max)
    L, _, W = rows.shape
    if round_bf16:
        rows = rows.to(torch.bfloat16).float()
    out = torch.zeros((L, s_max, W), dtype=torch.float32, device=rows.device)
    for l in range(L):
        out[l].index_add_(0, idx[l].long(), rows[l])
    return out


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor, s_max: int,
                     round_bf16: bool = False) -> torch.Tensor:
    """``[L, B]`` indices x ``[L, B, W]`` f32 rows -> ``[L, S_max, W]`` f32.

    Indices of level ``l`` must lie in ``[0, S_l)`` with ``S_l <= s_max`` (the
    hash encoder makes them mod the level size); the kernel does not check.
    ``round_bf16`` rounds each row value to bf16 (nearest even) first.
    """
    _check(idx, rows, s_max)
    if not on_card("scatter_add_rows", idx, rows):
        return scatter_add_rows_plain(idx, rows, s_max, round_bf16)
    L, _, W = rows.shape
    out = torch.empty((L, s_max, W), dtype=torch.float32, device=rows.device)
    return _launch_scatter(KERNEL_BF16 if round_bf16 else KERNEL, "scatter_add_rows",
                           idx, rows, out, s_max)


def _check_tiled(idx: torch.Tensor, rows: torch.Tensor, S: int, acc_dtype):
    if idx.dim() != 1 or rows.dim() != 2 or rows.shape[0] != idx.shape[0]:
        raise ValueError(f"expected idx [B] and rows [B, W], got "
                         f"{tuple(idx.shape)} and {tuple(rows.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32, got {rows.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    if acc_dtype not in TILED:
        raise TypeError(f"accumulator must be float32 or bfloat16, got {acc_dtype}")
    if S <= 0:
        raise ValueError(f"S must be positive, got {S}")


def scatter_rows_tiled_plain(idx: torch.Tensor, rows: torch.Tensor, S: int,
                             acc_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into an ``acc_dtype`` table of
    ``acc_dtype`` rows, widened to f32."""
    _check_tiled(idx, rows, S, acc_dtype)
    out = torch.zeros((S, rows.shape[1]), dtype=acc_dtype, device=rows.device)
    return out.index_add_(0, idx.long(), rows.to(acc_dtype)).float()


def scatter_rows_tiled(idx: torch.Tensor, rows: torch.Tensor, S: int,
                       acc_dtype=torch.float32) -> torch.Tensor:
    """``[B]`` indices in ``[0, S)`` x ``[B, W]`` f32 rows -> ``[S, W]`` f32,
    summed in ``acc_dtype`` (float32 or bfloat16); the kernel does not check
    the indices."""
    _check_tiled(idx, rows, S, acc_dtype)
    if not on_card("scatter_rows_tiled", idx, rows):
        return scatter_rows_tiled_plain(idx, rows, S, acc_dtype)
    out = torch.empty((S, rows.shape[1]), dtype=torch.float32, device=rows.device)
    return _launch_scatter(TILED[acc_dtype], "scatter_rows_tiled", idx[None], rows[None],
                           out, S)
