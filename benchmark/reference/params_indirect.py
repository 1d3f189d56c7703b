"""Initial weights of the interreflection model (``indirect.py``), made by
the benchmark from a seed as ``params.py`` makes the scene model's: the
same laws and the same two draws, over ``params.leaves``' list with the SDF
net's output widened by the learned blend channel (1 + geo feature +
roughness + blend) and ``renv_net`` [4, 64, 64, 64, env feature] appended
(ENVIDR's ``nerf/network.py:303-310``)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import params as base
from .model import Spec

RENV_HIDDEN = 64
RENV_LAYERS = 4


def leaves(spec: Spec) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every parameter of the configuration."""
    g, hid = spec["geo_feat_dim"], spec["hidden_dim"]
    sdf = base._mlp("sdf_net", [spec["num_levels"] * spec["level_dim"]]
                    + [hid] * (spec["num_layers"] - 1) + [1 + g + 2])
    out: List[Tuple[str, tuple, str, float]] = []
    for leaf in base.leaves(spec):
        if not leaf[0].startswith("sdf_net."):
            out.append(leaf)
        elif leaf[0] == "sdf_net.0.weight":
            out += sdf
    return out + base._mlp("renv_net", [4] + [RENV_HIDDEN] * (RENV_LAYERS - 1)
                           + [spec["env_feat_dim"]])


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of :func:`leaves`, float32 on ``device``, from ``seed``
    (``params.make``'s draws over this list)."""
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
