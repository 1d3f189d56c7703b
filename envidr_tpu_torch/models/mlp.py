"""Tiny-MLP building blocks (counterpart of ``envidr_tpu/models/mlp.py``).

A layer is an ``nn.Linear``; its ``weight`` is the transpose of the JAX
package's ``w`` ([out, in] against [in, out]).  A stack of E MLPs of one
shape (the env nets of sphere mode, a stacked pytree with a leading env
axis there) is a list of :class:`StackedLinear`, whose ``weight`` is
[E, out, in].  Initialisation follows the
same laws (xavier-uniform with ReLU gain on hidden layers, torch's default
U(+-1/sqrt(in)), or kaiming-normal), drawn from an explicit generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def init_linear(in_dim: int, out_dim: int, *, bias: bool = True,
                init: str = "xavier_uniform", gain: float = 1.0,
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, bias=bias)
    with torch.no_grad():
        if init == "xavier_uniform":
            lim = gain * math.sqrt(2.0 / (in_dim + out_dim)) * math.sqrt(3.0)
            layer.weight.uniform_(-lim, lim, generator=generator)
        elif init == "kaiming":
            layer.weight.normal_(0.0, math.sqrt(2.0 / in_dim), generator=generator)
        elif init == "torch_default":
            lim = 1.0 / math.sqrt(in_dim)
            layer.weight.uniform_(-lim, lim, generator=generator)
        else:
            raise ValueError(f"unknown init {init}")
        if bias:
            layer.bias.zero_()
    return layer


def init_mlp(dims: Sequence[int], *, bias: bool = True,
             init: str = "xavier_uniform", hidden_gain: float = math.sqrt(2.0),
             generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """dims = [in, h1, ..., out]: ReLU gain on all but the last layer."""
    n = len(dims) - 1
    return nn.ModuleList(
        init_linear(dims[i], dims[i + 1], bias=bias, init=init,
                    gain=hidden_gain if i < n - 1 else 1.0, generator=generator)
        for i in range(n))


def apply_mlp(layers: Sequence[Callable], x: torch.Tensor,
              act: Callable = F.relu) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < n - 1:
            x = act(x)
    return x


class StackedLinear(nn.Module):
    """E linear layers of one shape: ``weight`` [E, out, in], ``bias`` [E, out]."""

    def __init__(self, layers: Sequence[nn.Linear]):
        super().__init__()
        self.weight = nn.Parameter(torch.stack([l.weight.detach() for l in layers]))
        self.bias = (nn.Parameter(torch.stack([l.bias.detach() for l in layers]))
                     if layers[0].bias is not None else None)

    def pick(self, index) -> nn.Module:
        """Layer ``index`` (an int, or a 0-dim integer tensor read on its
        device, without a copy to the host) as a callable."""
        if isinstance(index, int):
            w, b = self.weight[index], None if self.bias is None else self.bias[index]
        else:
            i = index.reshape(1).long()
            w = self.weight.index_select(0, i)[0]
            b = None if self.bias is None else self.bias.index_select(0, i)[0]
        return lambda x: F.linear(x, w, b)


def stack_mlps(mlps: Sequence[nn.ModuleList]) -> nn.ModuleList:
    """E MLPs of one shape as one list of :class:`StackedLinear`."""
    return nn.ModuleList(StackedLinear(layers) for layers in zip(*mlps))


def apply_stacked_mlp(layers: nn.ModuleList, index, x: torch.Tensor,
                      act: Callable = F.relu) -> torch.Tensor:
    """MLP ``index`` of a stack made by :func:`stack_mlps`."""
    return apply_mlp([layer.pick(index) for layer in layers], x, act)


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """torch Softplus(beta): (1/beta) log(1 + exp(beta x)), linear above 20/beta."""
    return F.softplus(x, beta=beta, threshold=20.0)


def unit_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=-1) semantics (the norm is clamped from below)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def feat_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """geo_feat / env_feat activation menu."""
    if not kind:
        return x
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "unitNorm":
        return unit_norm(x)
    if kind == "instanceNorm":
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=True)
        return (x - mean) / torch.sqrt(var + 1e-5)
    raise ValueError(f"unknown feat act {kind}")
