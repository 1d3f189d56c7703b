"""Bridge from the JAX package's parameter pytree to :class:`NeRFNetwork`.

The pytree arrives as nested dicts/lists of numpy arrays (``np.asarray`` of
each leaf); nothing JAX-specific is read or unpickled.  A linear layer is
``{'w': [in, out], 'b': [out]}`` there and ``nn.Linear`` ([out, in]) here;
the encoder and the density's scalar are loose parameters named by their
pytree paths (``encoder.axes.0.2`` is ``params["encoder"]["axes"][0][2]``).
The stack of env nets of sphere mode (``env_nets``) is a list of layers
with a leading env axis in both: ``{'w': [E, in, out], 'b': [E, out]}`` there,
:class:`~envidr_tpu_torch.models.mlp.StackedLinear` ([E, out, in]) here.
One rule maps a module to its subtree (:func:`_layout`): a linear layer is
one ``{'w', 'b'}`` (the roughness head), a list of layers is an MLP, a
module that holds layers further down is a dict of its children (the
network, the background net ``{"encoder", "net"}``), and any other module
is loose leaves.

:func:`merge_mlp` is the JAX trainer's ``_merge_tolerant`` for one MLP, and
:func:`merge_leaves` for a module of loose leaves: a checkpoint tensor
smaller than the current one fills its leading corner.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from envidr_tpu_torch.models.mlp import StackedLinear


def _is_layer(module: nn.Module) -> bool:
    return isinstance(module, (nn.Linear, StackedLinear))


def _layout(module: nn.Module) -> str:
    """How ``module`` lies in the JAX pytree: ``"layer"``, ``"mlp"`` (a list
    of layers), ``"dict"`` (of its children) or ``"leaves"`` (loose
    parameters named by their paths: the encoders' tables, the density)."""
    if _is_layer(module):
        return "layer"
    if isinstance(module, nn.ModuleList) and all(_is_layer(m) for m in module):
        return "mlp"
    return "dict" if any(_is_layer(m) for m in module.modules()) else "leaves"


def _t(w) -> np.ndarray:
    """A JAX ``w`` ([..., in, out]) in the port's layout ([..., out, in])."""
    return np.swapaxes(np.asarray(w), -1, -2)


def _copy(dst: torch.Tensor, src, name: str):
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def _load_mlp(layers: nn.ModuleList, tree, name: str):
    if len(tree) != len(layers):
        raise ValueError(f"{name}: {len(tree)} layers, expected {len(layers)}")
    for i, (layer, p) in enumerate(zip(layers, tree)):
        _copy(layer.weight, _t(p["w"]), f"{name}[{i}].w")
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


def _load(module: nn.Module, tree, name: str):
    kind = _layout(module)
    if kind == "layer":
        _load_mlp([module], [tree], name)
    elif kind == "mlp":
        _load_mlp(module, tree, name)
    elif kind == "leaves":
        _load_leaves(module, tree, name)
    else:
        expected = {n for n, _ in module.named_children()}
        if set(tree) != expected:
            raise ValueError(f"{name}: pytree keys {sorted(tree)} != modules {sorted(expected)}")
        for n, child in module.named_children():
            _load(child, tree[n], f"{name}.{n}" if name else n)


@torch.no_grad()
def load_jax_params(net: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill ``net`` from a JAX parameter pytree; every key must match."""
    _load(net, params, "")
    return net


def module_arrays(module: nn.Module, tree) -> list:
    """The arrays of a JAX subtree in the order of ``module.parameters()``
    and in the port's layout (a linear layer's ``w`` transposed).  ``tree``
    may be any pytree of the parameters' structure, e.g. Adam moments."""
    kind = _layout(module)
    if kind == "layer":
        return module_arrays(nn.ModuleList([module]), [tree])
    if kind == "dict":
        return [a for n, child in module.named_children() for a in module_arrays(child, tree[n])]
    if kind == "mlp":
        out = []
        for layer, p in zip(module, tree):
            out.append(_t(p["w"]))
            if layer.bias is not None:
                out.append(np.asarray(p["b"]))
        return out
    leaves = dict(_flatten(tree))
    return [np.asarray(leaves[key]) for key, _ in module.named_parameters()]


def module_tree(module: nn.Module, tensors) -> Any:
    """Inverse of :func:`module_arrays`: ``tensors`` (one per parameter, in
    order) as a JAX-layout pytree of numpy arrays."""
    kind = _layout(module)
    if kind == "layer":
        return module_tree(nn.ModuleList([module]), tensors)[0]
    if kind == "dict":
        out, rest = {}, list(tensors)
        for n, child in module.named_children():
            k = len(list(child.parameters()))
            out[n], rest = module_tree(child, rest[:k]), rest[k:]
        return out
    arrays = [t.detach().cpu().numpy() for t in tensors]
    if kind == "mlp":
        out, it = [], iter(arrays)
        for layer in module:
            p = {"w": np.ascontiguousarray(_t(next(it)))}
            if layer.bias is not None:
                p["b"] = next(it)
            out.append(p)
        return out
    root: Dict[str, Any] = {}
    for (key, _), a in zip(module.named_parameters(), arrays):
        parts = key.split(".")
        node = root
        for k, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(k, {})
        node[parts[-1]] = a
    return _lists(root)


def network_tree(net: nn.Module) -> Dict[str, Any]:
    """Every top-level module of ``net`` as its JAX-layout pytree of numpy
    arrays (a checkpoint's ``params`` or ``ema``)."""
    return {n: module_tree(m, list(m.parameters())) for n, m in net.named_children()}


def _lists(node):
    """Dicts keyed 0..n-1 become lists (the CP encoder's ``axes``, ``proj``)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def mlp_from_tree(tree) -> nn.ModuleList:
    """An MLP built from a JAX-layout list of ``{"w": [in, out], "b": [out]}``
    (or a stack of them, ``w`` [E, in, out]: a list of ``StackedLinear``)."""
    layers = nn.ModuleList()
    for p in tree:
        w = np.asarray(p["w"], np.float32)
        b = np.asarray(p["b"], np.float32) if "b" in p else None
        linears = []
        for k in range(w.shape[0] if w.ndim == 3 else 1):
            wk, bk = (w[k], None if b is None else b[k]) if w.ndim == 3 else (w, b)
            layer = nn.Linear(wk.shape[0], wk.shape[1], bias=bk is not None)
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(wk.T)))
                if bk is not None:
                    layer.bias.copy_(torch.from_numpy(bk))
            linears.append(layer)
        layers.append(StackedLinear(linears) if w.ndim == 3 else linears[0])
    return layers


@torch.no_grad()
def merge_mlp(layers: nn.ModuleList, tree) -> nn.ModuleList:
    """``Trainer._merge_tolerant`` of the JAX package for one MLP: each
    checkpoint tensor replaces the current one where the shapes are equal and
    fills its leading corner where they are not (e.g. a 160-wide env net into
    a 256-wide one).  A checkpoint of another structure (layer count, bias,
    rank) is taken as it is, as the JAX trainer does.  Returns the module
    that now holds the weights: ``layers`` itself, or a new one."""
    def keys(layer):
        return {"w", "b"} if layer.bias is not None else {"w"}

    pairs = []
    if len(tree) == len(layers) and all(set(p) == keys(l) for l, p in zip(layers, tree)):
        for layer, p in zip(layers, tree):
            pairs.append((layer.weight, _t(np.asarray(p["w"], np.float32))))
            if layer.bias is not None:
                pairs.append((layer.bias, np.asarray(p["b"], np.float32)))
    if not pairs or any(dst.dim() != src.ndim for dst, src in pairs):
        return mlp_from_tree(tree).to(layers[0].weight.device)
    for dst, src in pairs:
        corner = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
        dst[corner] = torch.from_numpy(np.ascontiguousarray(src[corner])).to(dst.device)
    return layers


def merge_module(module: nn.Module, tree, name: str) -> nn.Module:
    """``_merge_tolerant`` of a whole module: an MLP by :func:`merge_mlp`, a
    lone layer as a one-layer MLP, a dict child by child, loose leaves by
    :func:`merge_leaves`.  Returns the module that now holds the weights."""
    kind = _layout(module)
    if kind == "mlp":
        return merge_mlp(module, tree)
    if kind == "layer":
        return merge_mlp(nn.ModuleList([module]), [tree])[0]
    if kind == "dict":
        for n, child in list(module.named_children()):
            setattr(module, n, merge_module(child, tree[n], f"{name}.{n}"))
        return module
    merge_leaves(module, tree, name)
    return module


@torch.no_grad()
def merge_leaves(module: nn.Module, tree, name: str):
    """``_merge_tolerant`` for a module of loose leaves (the encoder, the
    density's scalar): each array fills the leading corner of its parameter.
    Another set of leaves raises."""
    own = dict(module.named_parameters())
    leaves = dict(_flatten(tree))
    if set(leaves) != set(own):
        raise ValueError(f"{name}: the checkpoint holds leaves {sorted(leaves)}, "
                         f"the network {sorted(own)}")
    for key, p in own.items():
        a = np.asarray(leaves[key], np.float32)
        corner = tuple(slice(0, min(x, y)) for x, y in zip(p.shape, a.shape))
        p[corner] = torch.from_numpy(np.ascontiguousarray(a[corner])).to(p.device)
