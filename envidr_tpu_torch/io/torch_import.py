"""Read the reference framework's PyTorch ``.pth`` files into the JAX
package's parameter layout (counterpart of ``envidr_tpu/io/torch_import.py``).

A linear layer comes out as ``{"w": [in, out], "b": [out]}`` of numpy
arrays, as in the JAX pytree, so that one merge path
(:mod:`envidr_tpu_torch.io.jax_params`) serves ``.pth`` and ``.ckpt`` files
alike.  Files are read with ``weights_only=True``: a ``.pth`` cannot run
code when it is loaded.

Formats: full model state dicts (``{"model": {"sdf_net.0.weight": ...}}``,
the stack of sphere mode as ``env_nets.{e}.{layer}.weight``, the roughness
head ``roughness_layer.weight``), the
per-environment relighting nets ``env_net_{i}.pth`` (keys
``env_net{layer}.weight``, no dot before the index) and Sequential nets
(``0.weight``, ``2.weight``, ...).  Weight-norm layers are collapsed to plain
weights, ``w = g * v / ||v||_row``.  The reference's pretrained rendering
MLPs and env nets converted to numpy (``assets/rendering_mlps.npz`` and
``assets/env_nets.npz``, the layout of ``tools/convert_reference_ckpts.py``)
are read by :func:`load_npz_mlps` and :func:`load_npz_env_nets`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np
import torch


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file as a flat ``{key: ndarray}`` (``{"model": ...}`` unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray, int, float))}


def _collapse_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = dict(sd)
    for k in sd:
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            v = sd[k]
            norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1, keepdims=True)
            out[base + "weight"] = sd[base + "weight_g"] * v / np.maximum(norm, 1e-12)
            out.pop(k)
            out.pop(base + "weight_g", None)
    return out


def mlp_from_state(sd: Dict[str, np.ndarray], prefix: str = "") -> List[dict]:
    """``{prefix}{i}.weight`` / ``.bias`` as an ordered list of linears
    (ModuleList 0,1,2,..., Sequential 0,2,4,..., and ``env_net0.weight``)."""
    sd = _collapse_weight_norm(sd)
    pat = re.compile(re.escape(prefix) + r"\.?(\d+)\.weight$" if prefix else r"(\d+)\.weight$")
    found = sorted((int(m.group(1)), k) for k in sd for m in [pat.fullmatch(k)] if m)
    layers = []
    for _, wkey in found:
        layer = {"w": np.ascontiguousarray(sd[wkey].T)}
        bkey = wkey[: -len("weight")] + "bias"
        if bkey in sd:
            layer["b"] = sd[bkey]
        layers.append(layer)
    if not layers:
        raise KeyError(f"no linear layers under prefix {prefix!r}")
    return layers


def network_params_from_state(sd: Dict[str, np.ndarray]) -> dict:
    """The parts of a full-model state dict that the JAX package reads, as a
    JAX-layout pytree; what the file lacks is left out.  As there, the
    background MLP comes out under ``bg_net``, a key the network does not
    have (its background net is ``bg``), so a resume does not load it."""
    sd = _collapse_weight_norm(sd)
    params: dict = {}
    if "encoder.embeddings" in sd:
        params["encoder"] = {"embeddings": sd["encoder.embeddings"]}
    for leaf in ("beta", "variance"):
        if f"sdf_density.{leaf}" in sd:
            params["sdf_density"] = {leaf: sd[f"sdf_density.{leaf}"]}
    for name in ("sdf_net", "diffuse_net", "color_net", "renv_net", "env_net",
                 "diffuse_env_net", "bg_net"):
        try:
            params[name] = mlp_from_state(sd, name)
        except KeyError:
            pass
    if "roughness_layer.weight" in sd:
        params["roughness_layer"] = {"w": np.ascontiguousarray(sd["roughness_layer.weight"].T),
                                     "b": sd["roughness_layer.bias"]}
    # the stack of sphere mode: env_nets.{e}.{layer}.weight
    env_ids = sorted({int(m.group(1)) for k in sd for m in [re.match(r"env_nets\.(\d+)\.", k)] if m})
    if env_ids:
        params["env_nets"] = stack_trees([
            mlp_from_state({k[len(f"env_nets.{e}."):]: v for k, v in sd.items()
                            if k.startswith(f"env_nets.{e}.")}) for e in env_ids])
    return params


def stack_trees(mlps: Sequence[List[dict]]) -> List[dict]:
    """MLPs of one shape as one, each leaf stacked on a leading axis (the
    JAX package's ``env_nets`` pytree)."""
    return [{k: np.stack([m[i][k] for m in mlps]) for k in mlps[0][i]}
            for i in range(len(mlps[0]))]


def _npz_mlp(z, prefix: str) -> List[dict]:
    layers, i = [], 0
    while f"{prefix}.{i}.w" in z:
        layer = {"w": np.asarray(z[f"{prefix}.{i}.w"], np.float32)}
        if f"{prefix}.{i}.b" in z:
            layer["b"] = np.asarray(z[f"{prefix}.{i}.b"], np.float32)
        layers.append(layer)
        i += 1
    if not layers:
        raise KeyError(f"no layers {prefix}.* in the file")
    return layers


def load_npz_mlps(path: str, names=("diffuse_net", "renv_net", "color_net")) -> dict:
    """The MLPs ``names`` of an ``.npz`` written as ``{name}.{layer}.w`` /
    ``.b`` in the JAX layout (``assets/rendering_mlps.npz``)."""
    with np.load(path) as z:
        return {name: _npz_mlp(z, name) for name in names}


def load_npz_env_nets(path: str, ids: Sequence[int]) -> List[dict]:
    """The env nets ``ids`` of ``assets/env_nets.npz`` (``env_{i}.{layer}.w``)
    as the stacked pytree of sphere mode."""
    with np.load(path) as z:
        return stack_trees([_npz_mlp(z, f"env_{i}") for i in ids])


def load_env_net(path: str) -> List[dict]:
    """One relighting env MLP from an ``env_net_{i}.pth`` (or Sequential) file."""
    sd = load_state_dict(path)
    try:
        return mlp_from_state(sd, "env_net")
    except KeyError:
        return mlp_from_state(sd, "")
