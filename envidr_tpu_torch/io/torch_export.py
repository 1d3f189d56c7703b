"""Write the port's parameters as PyTorch checkpoints of the reference
framework (counterpart of ``envidr_tpu/io/torch_export.py``).

The inverse of :mod:`envidr_tpu_torch.io.torch_import`: full model state
dicts under the reference's module names (``nerf/network.py``), and the
per-environment relighting files of a sphere-mode run, ``env_net_{i}.pth``,
as ``extract_env_ckpt`` (``nerf/sph_loader.py:356-379``) writes them, with
its key quirk ``env_net{layer}.weight`` (no dot before the layer index).
Each function takes a JAX-layout pytree of numpy arrays (a checkpoint's
``params`` or ``ema``, or :func:`~envidr_tpu_torch.io.jax_params.network_tree`
of a network).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def mlp_to_state(layers: List[dict], prefix: str) -> "OrderedDict[str, torch.Tensor]":
    """``{prefix}.{i}.weight`` ([out, in]) and ``.bias`` of each layer."""
    sd = OrderedDict()
    for i, layer in enumerate(layers):
        sd[f"{prefix}.{i}.weight"] = _t(np.asarray(layer["w"]).T)
        if "b" in layer:
            sd[f"{prefix}.{i}.bias"] = _t(layer["b"])
    return sd


def network_state_dict(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """A network's pytree as a state dict of the reference's names."""
    sd = OrderedDict()
    if "encoder" in params and "embeddings" in params["encoder"]:
        sd["encoder.embeddings"] = _t(params["encoder"]["embeddings"])
    for k, v in params.get("sdf_density", {}).items():
        sd[f"sdf_density.{k}"] = _t(v)
    for name in ("sdf_net", "diffuse_net", "color_net", "renv_net", "env_net",
                 "diffuse_env_net"):
        if name in params:
            sd.update(mlp_to_state(params[name], name))
    if "roughness_layer" in params:
        sd["roughness_layer.weight"] = _t(np.asarray(params["roughness_layer"]["w"]).T)
        sd["roughness_layer.bias"] = _t(params["roughness_layer"]["b"])
    if "env_nets" in params:
        for e in range(np.asarray(params["env_nets"][0]["w"]).shape[0]):
            layers = [{k: np.asarray(v)[e] for k, v in layer.items()}
                      for layer in params["env_nets"]]
            sd.update(mlp_to_state(layers, f"env_nets.{e}"))
    return sd


def save_model_pth(params: dict, path: str, extra: Optional[Dict] = None) -> str:
    """``{"model": network_state_dict(params), **extra}`` to ``path``."""
    payload = {"model": network_state_dict(params)}
    if extra:
        payload.update(extra)
    torch.save(payload, path)
    return path


def extract_env_ckpts(params: dict, out_dir: str) -> List[str]:
    """Each env net of the stack ``params["env_nets"]`` as its own
    ``env_net_{i}.pth`` in ``out_dir``; returns the paths."""
    if "env_nets" not in params:
        raise ValueError("no stacked env_nets in params")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for e in range(np.asarray(params["env_nets"][0]["w"]).shape[0]):
        sd = OrderedDict()
        for i, layer in enumerate(params["env_nets"]):
            sd[f"env_net{i}.weight"] = _t(np.asarray(layer["w"])[e].T)
            if "b" in layer:
                sd[f"env_net{i}.bias"] = _t(np.asarray(layer["b"])[e])
        path = os.path.join(out_dir, f"env_net_{e}.pth")
        torch.save({"model": sd}, path)
        paths.append(path)
    return paths
