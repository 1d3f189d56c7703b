"""Batched scatter-add of hash-table gradient rows: CUDA kernel + plain version.

Counterpart of ``envidr_tpu/ops/pallas_scatter.py:scatter_add_rows`` (the
Pallas TPU kernel, body ``_kernel`` :45-61).  The kernel is
``csrc/scatter_add_rows.cu``: one launch computes
``idx [L, B] i32 x rows [L, B, W] f32 -> out [L, S_max, W] f32`` for all
levels at once, by atomicAdd into an output zeroed on the same stream.

What bounds it on an H100: bytes.  It reads ``L*B*(4 + 4W)`` bytes and writes
``L*S_max*W*4``; at the train step's shape (L=16, B=262,144, W=16,
S_max=2^19) that is ~822 MB, ~0.25 ms at 3.35 TB/s.

The TPU sizing helpers (``fits_vmem``, ``_pick_K``) size VMEM accumulators
and have no counterpart here: under ``hash_scatter_impl='mixed'`` every level
takes this kernel.

Build: ``nvcc`` compiles the source at first use into ``envidr_tpu_torch/_build/``
(keyed by a hash of the source and flags) and the library is loaded with
ctypes.  A CUDA tensor always takes the kernel; if the build or the launch
fails the wrapper raises.  A CPU tensor takes :func:`scatter_add_rows_plain`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "scatter_add_rows.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build csrc/scatter_add_rows.cu")
    return nvcc


class CudaLibrary:
    """A ``csrc/*.cu`` file built by nvcc into a shared library, loaded with
    ctypes; counts the launches made through it."""

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def build(self) -> Optional[float]:
        """Compile if no library for this source exists; returns the nvcc
        seconds, or None when the cached library was used."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: "
                               f"{' '.join(cmd)}") from e
        if proc.returncode != 0:
            print(proc.stderr, flush=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        os.replace(tmp, out)           # atomic: concurrent builds race safely
        return time.perf_counter() - t0

    def fn(self):
        if self._fn is None:
            self.build()
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


KERNEL = CudaLibrary(
    SOURCE, "scatter_add_rows_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])


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
                           s_max: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` per level."""
    _check(idx, rows, s_max)
    L, _, W = rows.shape
    out = torch.zeros((L, s_max, W), dtype=torch.float32, device=rows.device)
    for l in range(L):
        out[l].index_add_(0, idx[l].long(), rows[l])
    return out


def scatter_add_rows(idx: torch.Tensor, rows: torch.Tensor,
                     s_max: int) -> torch.Tensor:
    """``[L, B]`` indices x ``[L, B, W]`` f32 rows -> ``[L, S_max, W]`` f32.

    Indices of level ``l`` must lie in ``[0, S_l)`` with ``S_l <= s_max`` (the
    hash encoder makes them mod the level size); the kernel does not check.
    """
    _check(idx, rows, s_max)
    if rows.device.type == "cpu" and idx.device.type == "cpu":
        return scatter_add_rows_plain(idx, rows, s_max)
    if rows.device.type != "cuda" or idx.device != rows.device:
        raise ValueError(f"scatter_add_rows: tensors on {idx.device} and "
                         f"{rows.device}; expected both on one CUDA device")
    L, B, W = rows.shape
    if W % 4:
        raise ValueError(f"row width {W} is not a multiple of 4 (float4 loads)")
    idx = idx.to(torch.int32).contiguous()
    rows = rows.contiguous()
    out = torch.empty((L, s_max, W), dtype=torch.float32, device=rows.device)
    fn = KERNEL.fn()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(idx.data_ptr(), rows.data_ptr(), out.data_ptr(), L, B, s_max,
                 W, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: cudaError {err}")
    KERNEL.launches += 1
    return out
