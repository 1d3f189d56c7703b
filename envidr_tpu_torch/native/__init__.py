"""Host-side C++ of the port, built with g++ and loaded with ctypes
(counterpart of ``envidr_tpu/native/``).

``mtets.cpp`` (marching tetrahedra) is compiled at first use into
``envidr_tpu_torch/_build/`` under a name keyed by a hash of the source and
the flags, written to a temporary file and renamed, so that concurrent
builds race safely and an edited source is rebuilt.  A failed build raises:
nothing falls back to the numpy version, which
:func:`envidr_tpu_torch.apps.mesh_extract.marching_tets` runs only when its
caller asks for it by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mtets.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_TIMEOUT_S = 300
_lib = None


class _MtResult(ctypes.Structure):
    _fields_ = [("verts", ctypes.POINTER(ctypes.c_double)),
                ("faces", ctypes.POINTER(ctypes.c_int64)),
                ("n_verts", ctypes.c_int64),
                ("n_faces", ctypes.c_int64)]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"mtets-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``mtets.cpp`` unless its library exists; returns the path.
    Raises when g++ is missing, fails or times out."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: it builds envidr_tpu_torch/native/mtets.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=GXX_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ timed out after {GXX_TIMEOUT_S} s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_mtets():
    """The built library, its two functions typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.marching_tets.restype = ctypes.POINTER(_MtResult)
        lib.marching_tets.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                      ctypes.c_float]
        lib.free_result.argtypes = [ctypes.POINTER(_MtResult)]
        _lib = lib
    return _lib


def marching_tets_native(field: np.ndarray, iso: float = 0.0):
    """``field`` [R, R, R] -> (verts [V, 3] float64 in voxel coordinates,
    faces [F, 3] int64), welded as the numpy version welds them."""
    lib = load_mtets()
    f = np.ascontiguousarray(field, np.float32)
    res = lib.marching_tets(f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), f.shape[0],
                            float(iso))
    try:
        nv, nf = res.contents.n_verts, res.contents.n_faces
        verts = (np.ctypeslib.as_array(res.contents.verts, (nv, 3)).copy() if nv
                 else np.zeros((0, 3)))
        faces = (np.ctypeslib.as_array(res.contents.faces, (nf, 3)).copy() if nf
                 else np.zeros((0, 3), np.int64))
    finally:
        lib.free_result(res)
    return verts, faces
