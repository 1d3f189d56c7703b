"""Initial weights made by the benchmark from a seed, on the device, in a
few large calls.

The laws are ENVIDR's (the torch-ngp / JAX trainer's init): MLP weights
xavier-uniform with the ReLU gain sqrt(2) on hidden layers and 1 on the
last, biases zero but the colour head's last bias at -log(3); the hash
table U(-1e-4, 1e-4); the Laplace beta at ``init_beta``; NeuS's variance
at ``init_variance``; CP tables N(0, 0.1^2) and projections N(0, 1/rank).
One uniform and one normal draw of all the leaves' elements from a
``torch.Generator`` on the device, sliced and scaled leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .model import Spec


def _mlp(name: str, dims: List[int]) -> List[Tuple[str, tuple, str, float]]:
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        gain = 1.0 if i == len(dims) - 2 else math.sqrt(2.0)
        out.append((f"{name}.{i}.weight", (b, a), "uniform",
                    gain * math.sqrt(2.0 / (a + b)) * math.sqrt(3.0)))
        out.append((f"{name}.{i}.bias", (b,), "zero", 0.0))
    return out


def leaves(spec: Spec) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every parameter of the configuration."""
    L, C, g = spec["num_levels"], spec["level_dim"], spec["geo_feat_dim"]
    hid = spec["hidden_dim"]
    out: List[Tuple[str, tuple, str, float]] = []
    if spec["encoding_pos"] == "cp":
        rank = spec["cp_rank"]
        for lvl, R in enumerate(spec.res):
            out += [(f"encoder.axes.{lvl}.{a}", (R, rank), "normal", 0.1) for a in range(3)]
        out += [(f"encoder.proj.{lvl}", (rank, C), "normal", 1.0 / math.sqrt(rank))
                for lvl in range(L)]
    else:
        out.append(("encoder.embeddings", (spec.offsets[-1], C), "uniform", 1e-4))
    if spec["use_neus_sdf"]:
        out.append(("sdf_density.variance", (), "const", spec["init_variance"]))
    else:
        out.append(("sdf_density.beta", (), "const", spec["init_beta"]))
    out += _mlp("sdf_net", [L * C] + [hid] * (spec["num_layers"] - 1) + [1 + g + 1])
    ide_dim = (2 ** spec["sh_degree"] - 1 + spec["sh_degree"]) * 2
    env = spec["env_feat_dim"]
    out += _mlp("diffuse_net", [g + env] + [spec["hidden_dim_diffuse"]]
                * (spec["num_layers_diffuse"] - 1) + [3])
    out += _mlp("color_net", [g + 3 + env + 1] + [spec["hidden_dim_color"]]
                * (spec["num_layers_color"] - 1) + [3])
    out += _mlp("env_net", [ide_dim] + [spec["hidden_dim_env"]]
                * (spec["num_layers_env"] - 1) + [env])
    return out


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of :func:`leaves`, float32 on ``device``, from ``seed``."""
    specs = leaves(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = {law: sum(math.prod(s) for _, s, l, _ in specs if l == law)
         for law in ("uniform", "normal")}
    pool = {"uniform": torch.rand(n["uniform"], generator=gen, device=device) * 2.0 - 1.0,
            "normal": torch.randn(n["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, law, scale in specs:
        if law in pool:
            k = math.prod(shape)
            out[name] = (pool[law][at[law]:at[law] + k] * scale).reshape(shape)
            at[law] += k
        else:
            out[name] = torch.full(shape, scale if law == "const" else 0.0, device=device)
    out["color_net.%d.bias" % (spec["num_layers_color"] - 1)] -= math.log(3.0)
    return out
