"""Bridge from the JAX package's parameter pytree to :class:`NeRFNetwork`.

The pytree arrives as nested dicts/lists of numpy arrays (``np.asarray`` of
each leaf); nothing JAX-specific is read or unpickled.  A linear layer is
``{'w': [in, out], 'b': [out]}`` there and ``nn.Linear`` ([out, in]) here;
the encoder and the density's scalar are loose parameters named by their
pytree paths (``encoder.axes.0.2`` is ``params["encoder"]["axes"][0][2]``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def _copy(dst: torch.Tensor, src, name: str):
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def _load_mlp(layers: nn.ModuleList, tree, name: str):
    if len(tree) != len(layers):
        raise ValueError(f"{name}: {len(tree)} layers, expected {len(layers)}")
    for i, (layer, p) in enumerate(zip(layers, tree)):
        _copy(layer.weight, np.asarray(p["w"]).T, f"{name}[{i}].w")
        if layer.bias is not None:
            _copy(layer.bias, p["b"], f"{name}[{i}].b")
        elif "b" in p:
            raise ValueError(f"{name}[{i}]: unexpected bias")


def _load_leaves(module: nn.Module, tree, name: str):
    """A module of loose parameters named by their pytree paths (the hash
    table ``embeddings``, the CP tables ``axes.<l>.<a>`` and ``proj.<l>``,
    ``beta`` or ``variance``): the two key sets must be equal."""
    leaves = dict(_flatten(tree))
    own = dict(module.named_parameters())
    if set(leaves) != set(own):
        raise ValueError(f"{name}: pytree leaves {sorted(leaves)} != parameters {sorted(own)}")
    for key, t in own.items():
        _copy(t, leaves[key], f"{name}.{key}")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items for kv in _flatten(v, f"{prefix}.{k}" if prefix else str(k))]


@torch.no_grad()
def load_jax_params(net: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill ``net`` from a JAX parameter pytree; every key must match."""
    expected = {name for name, _ in net.named_children()}
    if set(params) != expected:
        raise ValueError(f"pytree keys {sorted(params)} != modules {sorted(expected)}")
    for name in ("encoder", "sdf_density"):
        _load_leaves(getattr(net, name), params[name], name)
    for name in ("sdf_net", "diffuse_net", "color_net", "env_net"):
        if name in params:
            _load_mlp(getattr(net, name), params[name], name)
    return net

