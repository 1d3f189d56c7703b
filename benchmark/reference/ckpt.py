"""The benchmark's own reader of a JAX-trainer checkpoint.

A checkpoint is a pickle of plain containers and numpy arrays; a full one
also pickles optax's state tuples.  :func:`read` unpickles numpy arrays and
stand-ins for those tuples and refuses every other global, so reading a
file runs no code.  :func:`flat_params` turns the JAX parameter pytree into
one dict keyed by the names a ``torch.nn.Module`` of the same layout would
give its parameters (``sdf_net.0.weight`` is the transpose of the pytree's
``sdf_net[0]["w"]``), which is how the benchmark hands the same arrays to
the program and to the reference.
"""

from __future__ import annotations

import collections
import importlib
import pickle
from typing import Dict

import numpy as np

_STANDINS = {
    ("optax._src.base", "EmptyState"): collections.namedtuple("EmptyState", []),
    ("optax._src.transform", "ScaleByAdamState"):
        collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"]),
    ("optax._src.transform", "ScaleByScheduleState"):
        collections.namedtuple("ScaleByScheduleState", ["count"]),
    ("optax.transforms._combining", "PartitionState"):
        collections.namedtuple("PartitionState", ["inner_states"]),
    ("optax.transforms._conditionality", "ApplyIfFiniteState"):
        collections.namedtuple("ApplyIfFiniteState",
                               ["notfinite_count", "last_finite", "total_notfinite",
                                "inner_state"]),
    ("optax.transforms._masking", "MaskedState"):
        collections.namedtuple("MaskedState", ["inner_state"]),
    ("optax.transforms._masking", "MaskedNode"): collections.namedtuple("MaskedNode", []),
}
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"), ("numpy.core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar")}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _STANDINS:
            return _STANDINS[(module, name)]
        canon = module.replace("numpy._core", "numpy.core", 1)
        if (canon, name) not in _NUMPY:
            raise pickle.UnpicklingError(f"checkpoint names {module}.{name}")
        if canon == "numpy":
            return getattr(np, name)
        try:
            mod = importlib.import_module("numpy._core.multiarray")
        except ImportError:
            mod = importlib.import_module("numpy.core.multiarray")
        return getattr(mod, name)


def read(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def flat_params(tree: dict) -> Dict[str, np.ndarray]:
    """The pytree's leaves as float32 arrays under module-style names: an
    MLP layer's ``w`` [in, out] becomes ``<net>.<i>.weight`` [out, in] and
    its ``b`` ``<net>.<i>.bias``; the CP tables ``encoder.axes.<level>.<axis>``
    and ``encoder.proj.<level>``; loose leaves keep their path."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if set(node) <= {"w", "b"} and "w" in node:
                out[f"{path}.weight"] = np.ascontiguousarray(np.asarray(node["w"], np.float32).T)
                if "b" in node:
                    out[f"{path}.bias"] = np.asarray(node["b"], np.float32)
                return
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            out[path] = np.asarray(node, np.float32)

    walk(tree, "")
    return out
