"""PyTorch + CUDA port of ``envidr_tpu`` for one NVIDIA H100.

The JAX package ``envidr_tpu`` stays the reference; this package mirrors its
module names (``ops/hashgrid.py`` here is the counterpart of
``envidr_tpu/ops/hashgrid.py``).  It imports torch and numpy only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device given and no card present they raise (:func:`resolve_device`).
"""

from __future__ import annotations

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
