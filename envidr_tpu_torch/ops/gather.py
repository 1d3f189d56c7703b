"""Row gather ``table [S, W] f32 x idx [B] -> [B, W] f32``: CUDA kernel +
plain version.

Counterpart of the Pallas TPU kernels of the gather micro-benchmark,
``tools/bench_scatter.py:182`` ``g_pallas_take`` and ``:209``
``g_pallas_taa`` (a gather from a VMEM-resident table; both compute
``table[idx]``), and ``:249`` ``g_pallas_onehot`` (a one-hot x table product
in bf16 with f32 sums, which is ``f32(bf16(table[idx]))``: ``round_bf16``).
The kernel is ``csrc/gather_rows.cu``, one thread per float4 of an output row
with the table read through the read-only path (the TPU's VMEM table, 256 KiB
in f32, does not fit a Hopper block's shared memory; it sits in L2).

What bounds it on an H100: bytes, the index and output plus the table rows
the indices touch.

A CUDA tensor always takes the kernel and raises if the build or the launch
fails; a CPU tensor takes :func:`gather_rows_plain`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from envidr_tpu_torch.ops._cuda import CudaLibrary, launch, on_card

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gather_rows.cu"
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_void_p]
KERNEL = CudaLibrary(SOURCE, "gather_rows_f32_launch", _ARGS)
KERNEL_BF16 = CudaLibrary(SOURCE, "gather_rows_round_bf16_launch", _ARGS)


def _check(table: torch.Tensor, idx: torch.Tensor):
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [S, W] and idx [B], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``index_select``, then the bf16 round trip."""
    _check(table, idx)
    out = table.index_select(0, idx.long())
    return out.to(torch.bfloat16).float() if round_bf16 else out


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                round_bf16: bool = False) -> torch.Tensor:
    """``[S, W]`` f32 table x ``[B]`` indices in ``[0, S)`` -> ``[B, W]`` f32;
    with ``round_bf16`` each value is rounded to bf16 (nearest even) and
    widened back.  The kernel does not check the indices."""
    _check(table, idx)
    if not on_card("gather_rows", table, idx):
        return gather_rows_plain(table, idx, round_bf16)
    B, W = idx.shape[0], table.shape[1]
    if W % 4:
        raise ValueError(f"row width {W} is not a multiple of 4 (float4 loads)")
    table = table.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((B, W), dtype=torch.float32, device=table.device)
    launch(KERNEL_BF16 if round_bf16 else KERNEL, "gather_rows", table.device,
           table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, W)
    return out
