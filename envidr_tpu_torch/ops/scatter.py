"""Scatter-add of hash-table gradient rows: CUDA kernels + plain versions.

:func:`scatter_add_rows` is the counterpart of
``envidr_tpu/ops/pallas_scatter.py:scatter_add_rows`` (the Pallas TPU kernel,
body ``_kernel`` :45-61).  The kernel is
``csrc/scatter_add_rows.cu``: one launch computes
``idx [L, B] i32 x rows [L, B, W] f32 -> out [L, S_max, W] f32`` for all
levels at once, by atomicAdd into an output zeroed on the same stream.

What bounds it on an H100: bytes.  It reads ``L*B*(4 + 4W)`` bytes and writes
``L*S_max*W*4``; at the train step's shape (L=16, B=262,144, W=16,
S_max=2^19) that is ~822 MB, ~0.25 ms at 3.35 TB/s.

The TPU sizing helpers (``fits_vmem``, ``_pick_K``) size VMEM accumulators
and have no counterpart here: under ``hash_scatter_impl='mixed'`` every level
takes this kernel.  With ``round_bf16`` the same source's second entry point
rounds each row value to bf16 before the f32 add: the counterpart of
``tools/bench_scatter.py:287`` ``s_pallas_onehot``.

:func:`scatter_rows_tiled` (``csrc/scatter_rows_tiled.cu``) is the one-level
scatter ``[B] x [B, W] -> [S, W]`` through shared-memory row tiles, with an
f32 or a bf16 accumulator: the counterpart of the micro-benchmarks' Pallas
scatters ``tools/bench_scatter.py:324`` ``s_pallas_fori``,
``tools/bench_scatter2.py:126`` ``make_pallas_multi`` and
``tools/bench_gs4.py:51`` ``make_tiled``.  Bound: bytes, ``B*(4 + 4W)`` read
and ``S*W*4`` written.

Build and launch: ``ops/_cuda.py``.  A CUDA tensor always takes the kernel;
if the build or the launch fails the wrapper raises.  A CPU tensor takes the plain version
(:func:`scatter_add_rows_plain`, :func:`scatter_rows_tiled_plain`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from envidr_tpu_torch.ops._cuda import CudaLibrary, launch, on_card

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "scatter_add_rows.cu"
TILED_SOURCE = _CSRC / "scatter_rows_tiled.cu"

_SCATTER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
KERNEL = CudaLibrary(SOURCE, "scatter_add_rows_launch", _SCATTER_ARGS)
KERNEL_BF16 = CudaLibrary(SOURCE, "scatter_add_rows_round_bf16_launch", _SCATTER_ARGS)

_TILED_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
TILED = {torch.float32: CudaLibrary(TILED_SOURCE, "scatter_rows_tiled_f32_launch",
                                    _TILED_ARGS),
         torch.bfloat16: CudaLibrary(TILED_SOURCE, "scatter_rows_tiled_bf16_launch",
                                     _TILED_ARGS)}


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


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor,
                     s_max: int, round_bf16: bool = False) -> torch.Tensor:
    """``[L, B]`` indices x ``[L, B, W]`` f32 rows -> ``[L, S_max, W]`` f32.

    Indices of level ``l`` must lie in ``[0, S_l)`` with ``S_l <= s_max`` (the
    hash encoder makes them mod the level size); the kernel does not check.
    ``round_bf16`` rounds each row value to bf16 (nearest even) first.
    """
    _check(idx, rows, s_max)
    if not on_card("scatter_add_rows", idx, rows):
        return scatter_add_rows_plain(idx, rows, s_max, round_bf16)
    L, B, W = rows.shape
    if W % 4:
        raise ValueError(f"row width {W} is not a multiple of 4 (float4 loads)")
    idx = idx.to(torch.int32).contiguous()
    rows = rows.contiguous()
    out = torch.empty((L, s_max, W), dtype=torch.float32, device=rows.device)
    launch(KERNEL_BF16 if round_bf16 else KERNEL, "scatter_add_rows", rows.device,
           idx.data_ptr(), rows.data_ptr(), out.data_ptr(), L, B, s_max, W)
    return out


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
    B, W = rows.shape
    if W % 4:
        raise ValueError(f"row width {W} is not a multiple of 4 (float4 loads)")
    idx = idx.to(torch.int32).contiguous()
    rows = rows.contiguous()
    out = torch.empty((S, W), dtype=torch.float32, device=rows.device)
    launch(TILED[acc_dtype], "scatter_rows_tiled", rows.device,
           idx.data_ptr(), rows.data_ptr(), out.data_ptr(), B, S, W)
    return out
