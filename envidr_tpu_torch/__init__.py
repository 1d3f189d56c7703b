"""PyTorch + CUDA port of ``envidr_tpu`` for one NVIDIA H100.

The JAX package ``envidr_tpu`` stays the reference; this package mirrors its
module names (``ops/hashgrid.py`` here is the counterpart of
``envidr_tpu/ops/hashgrid.py``).  It imports torch and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no card present they raise (:func:`resolve_device`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, or an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "envidr_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor of ``values`` (numbers, sequences or a numpy array),
    made once per (values, dtype, device) and shared: a copy from host
    memory blocks the host, so the train step uploads its constants only at
    their first use.  Callers must not write into it."""
    return _constant(_frozen(np.asarray(values).tolist()), dtype, torch.device(device))


def _frozen(v):
    return tuple(map(_frozen, v)) if isinstance(v, list) else v
