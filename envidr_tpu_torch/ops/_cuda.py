"""Build, load and launch the hand-written kernels of ``csrc/``.

Each ``csrc/*.cu`` source has a plain C interface: one ``extern "C"``
launcher per instantiation, which takes device pointers, sizes and a stream
and returns its ``cudaError_t``.  ``nvcc`` compiles a source at first use
into ``envidr_tpu_torch/_build/`` (keyed by a hash of the source and the
flags) and the library is loaded with ctypes.  Every :class:`CudaLibrary`
counts the launches made through it and is listed in :data:`LIBRARIES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600
LIBRARIES: List["CudaLibrary"] = []       # every launcher, in creation order


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels of csrc/")
    return nvcc


class CudaLibrary:
    """One launcher of a ``csrc/*.cu`` file built by nvcc into a shared
    library, loaded with ctypes; counts the launches made through it."""

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        LIBRARIES.append(self)

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


def launch_counts() -> Dict[str, int]:
    """``{launcher symbol: launches so far}`` of every library."""
    return {lib.symbol: lib.launches for lib in LIBRARIES}


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the plain version's case),
    True when all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "expected all on the CPU or all on one CUDA device")
    return True


def launch(lib: CudaLibrary, name: str, device: torch.device, *args) -> None:
    """Call ``lib``'s launcher on ``device``'s current stream; raise on a
    non-zero cudaError, else count the launch."""
    fn = lib.fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    lib.launches += 1
