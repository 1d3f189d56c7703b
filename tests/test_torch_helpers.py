"""Shared set-up of the PyTorch-port parity tests (this module holds no tests):
the same small model in both packages, with parameters drawn once and handed
over as numpy."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Any, Dict

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_INI = os.path.join(ROOT, "configs", "synth_spheres.ini")

# synth_spheres.ini cut to test size: 4 levels, 2^12 table rows, width-16 MLPs
SMALL = dict(num_levels=4, log2_hashmap_size=12, desired_resolution=64,
             hidden_dim=16, hidden_dim_color=16, hidden_dim_env=16, num_rays=64,
             hash_scatter_impl="mixed", hash_custom_grad="on")


def small_options(**extra):
    """(JAX Options, port Options) of the small synth_spheres config."""
    from envidr_tpu.config import load_options as jax_load
    from envidr_tpu_torch.config import load_options as torch_load
    kw = {**SMALL, **extra}
    return jax_load(SYNTH_INI, **kw), torch_load(SYNTH_INI, **kw)


def shared_model(seed: int = 0, **extra):
    """JAX (cfg, params as numpy) and the port's (cfg, net) with equal weights.

    The hash table is redrawn U(-0.1, 0.1) so that encodings and their
    gradients are far from zero."""
    from envidr_tpu.config import network_config as jax_netcfg
    from envidr_tpu.models.network import init_network_params
    from envidr_tpu_torch.config import network_config as torch_netcfg
    from envidr_tpu_torch.io.jax_params import load_jax_params
    from envidr_tpu_torch.models.network import NeRFNetwork

    jopt, topt = small_options(**extra)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    emb = params["encoder"]["embeddings"]
    params["encoder"]["embeddings"] = rng.uniform(-0.1, 0.1, emb.shape).astype(np.float32)
    net = load_jax_params(NeRFNetwork(tcfg), params)
    return (jopt, jcfg, params), (topt, tcfg, net)


CP_LAPLACE_INI = os.path.join(ROOT, "configs", "synth_spheres_cp_laplace.ini")
# the CP configs cut to test size: 4 levels up to resolution 64, rank 8,
# width-16 MLPs
CP_SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                hidden_dim_color=16, hidden_dim_env=16, num_rays=64)


FIT_POINTS = 2048


def fit_sdf(net, seed: int, radius: float = 0.95, steps: int = 150):
    """``steps`` Adam steps (lr 1e-2) of ``net``'s encoder and SDF net
    towards ``|x| - radius`` on ``FIT_POINTS`` uniform points of [-1, 1]^3
    each, drawn from ``seed``; the gradients are cleared.  A fitted SDF's
    normals are well-conditioned (ROADMAP trap 3)."""
    g = torch.Generator().manual_seed(seed)
    fitted = [p for n, p in net.named_parameters() if n.startswith(("encoder", "sdf_net"))]
    adam = torch.optim.Adam(fitted, lr=1e-2)
    for _ in range(steps):
        x = torch.rand((FIT_POINTS, 3), generator=g) * 2.0 - 1.0
        sdf = net.forward_geometry(x)["sdf"]
        loss = ((sdf - (torch.linalg.vector_norm(x, dim=-1) - radius)) ** 2).mean()
        adam.zero_grad()
        loss.backward()
        adam.step()
    net.zero_grad(set_to_none=True)


@functools.lru_cache(maxsize=None)
def _fitted_params(ini: str, seed: int, radius: float, steps: int, extra: tuple):
    """The numpy pytree of :func:`fitted_model`, fitted once a process."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.models.network import init_network_params
    from envidr_tpu_torch.config import load_options as torch_load
    from envidr_tpu_torch.config import network_config as torch_netcfg
    from envidr_tpu_torch.io.jax_params import load_jax_params
    from envidr_tpu_torch.models.network import NeRFNetwork

    kw = {**CP_SMALL, **dict(extra)}
    jcfg = jax_netcfg(jax_load(ini, **kw))
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    net = load_jax_params(NeRFNetwork(torch_netcfg(torch_load(ini, **kw))), params)
    if hasattr(net, "cp_spec"):             # fit in f32, whatever the context
        net.cp_spec = dataclasses.replace(net.cp_spec, compute_dtype="float32")
    fit_sdf(net, seed, radius, steps)
    return jax.tree.map(np.copy, export_jax_layout(net))


def fitted_model(ini: str = CP_LAPLACE_INI, seed: int = 0, radius: float = 0.95,
                 steps: int = 150, **extra):
    """JAX (opt, cfg, params as numpy) and the port's (opt, cfg, net) of the
    small ``ini`` with ``extra`` and equal weights (JAX's draws carried
    across), the SDF fitted to the sphere of ``radius`` (:func:`fit_sdf`),
    so that rays from :func:`camera_rays` meet a surface.  The net takes the
    CP encoder's dtype of the caller's context."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu_torch.config import load_options as torch_load
    from envidr_tpu_torch.config import network_config as torch_netcfg
    from envidr_tpu_torch.io.jax_params import load_jax_params
    from envidr_tpu_torch.models.network import NeRFNetwork

    params = _fitted_params(ini, seed, radius, steps, tuple(sorted(extra.items())))
    kw = {**CP_SMALL, **extra}
    jopt, topt = jax_load(ini, **kw), torch_load(ini, **kw)
    tcfg = torch_netcfg(topt)
    return (jopt, jax_netcfg(jopt), params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg),
                                                                          params))


def _one_torch_thread():
    """One intra-op thread for torch while a module's tests run: under
    pytest-xdist every worker's default of one thread a core oversubscribes
    the machine, and a full-width render on the CPU (the checkpoint tests)
    then takes ~100x its time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_torch_thread_fixture(scope: str = "module", autouse: bool = True):
    """``_one_torch_thread`` as a fixture; a test module takes it with
    ``one_torch_thread = one_torch_thread_fixture()`` (all its tests) or
    ``one_torch_thread_fixture("function", False)`` and
    ``@pytest.mark.usefixtures("one_torch_thread")`` (some)."""
    import pytest
    return pytest.fixture(autouse=autouse, scope=scope)(_one_torch_thread)


@contextlib.contextmanager
def f32_cp_encoder():
    """Both packages' ``NetworkConfig.cp_spec`` with ``compute_dtype='float32'``
    while the block runs: a jitted JAX step then computes what the port
    computes (under ``jit`` XLA drops the bf16 encoder's roundings, trap C3)."""
    import pytest

    import envidr_tpu.models.network as jnet
    import envidr_tpu_torch.models.network as tnet

    with pytest.MonkeyPatch.context() as mp:
        for m in (jnet, tnet):
            spec = m.NetworkConfig.cp_spec
            mp.setattr(m.NetworkConfig, "cp_spec", property(
                lambda cfg, spec=spec: dataclasses.replace(spec.fget(cfg),
                                                           compute_dtype="float32")))
        yield


def jit_keeping_bf16(fn):
    """``fn`` of one pytree argument, compiled with XLA's
    ``xla_allow_excess_precision`` off: by default XLA drops bf16 roundings
    under ``jit`` (trap C3); with it off the compiled function rounds where
    the op-by-op one (``jax.disable_jit``) and the port round, in a fraction
    of the op-by-op time."""
    def run(p):
        return jax.jit(fn).lower(p).compile(
            compiler_options={"xla_allow_excess_precision": False})(p)
    return run


def rel_err(a, b) -> float:
    """max |a - b| / max |a| (the tolerance convention of ROADMAP C-3)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def camera_rays(n: int, seed: int = 0):
    """n rays from around (0, 0, 2.5) towards the central [-0.5, 0.5]^3."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 0.1, (n, 3)).astype(np.float32) + np.float32([0.0, 0.0, 2.5])
    t = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = t - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def export_jax_layout(net, grads: bool = False) -> Dict[str, Any]:
    """The parameters (or their ``.grad``) of ``net`` as a JAX-layout pytree
    of numpy arrays, e.g. to compare gradients with the JAX package.  A
    parameter without a gradient reads as zeros, as JAX would return."""
    from envidr_tpu_torch.io.jax_params import module_tree

    def val(t):
        if grads:
            t = torch.zeros_like(t) if t.grad is None else t.grad
        return t

    return {name: module_tree(m, [val(p) for p in m.parameters()])
            for name, m in net.named_children()}


def load_tool_functions(script: str, names, consts: Dict[str, Any]) -> Dict[str, Any]:
    """The functions ``names`` of a TPU micro-benchmark under ``tools/``,
    runnable on the CPU.

    The scripts run their whole benchmark when imported, so the wanted
    ``def``s are cut out of the source with ``ast`` and executed in a
    namespace that holds ``consts`` (the scripts' module-level sizes, made
    small), ``jax``, ``jnp``, ``pltpu`` and a ``pl`` whose ``pallas_call``
    runs in interpret mode.  Nothing in ``tools/`` changes.
    """
    import ast
    import functools
    import types

    import jax.numpy as jnp
    from jax.experimental import pallas as real_pl
    from jax.experimental.pallas import tpu as pltpu

    path = os.path.join(ROOT, "tools", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    missing = set(names) - {d.name for d in defs}
    assert not missing, f"{script} has no {sorted(missing)}"
    pl = types.SimpleNamespace(**{k: getattr(real_pl, k) for k in dir(real_pl)
                                  if not k.startswith("_")})
    pl.pallas_call = functools.partial(real_pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "functools": functools,
          **consts}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns


def tool_row_templates(script: str):
    """Regexes of the row names a TPU micro-benchmark under ``tools/``
    prints: the first argument of each ``report(...)`` call, or the text
    before the time of each ``print(f"... {t...} ms")``.  Formatted fields
    match anything, digits any number (the port names rows by the shapes it
    runs at), whitespace any whitespace."""
    import ast
    import re

    def piece(text):
        out = ""
        for tok in re.split(r"(\d+|\s+)", text):
            if tok.isdigit():
                out += r"\d+"
            elif tok and tok.isspace():
                out += r"\s+"
            else:
                out += re.escape(tok)
        return out

    with open(os.path.join(ROOT, "tools", script)) as f:
        tree = ast.parse(f.read())
    templates = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.args):
            continue
        arg = node.args[0]
        if node.func.id == "report":
            parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
        elif (node.func.id == "print" and isinstance(arg, ast.JoinedStr)
              and isinstance(arg.values[-1], ast.Constant) and arg.values[-1].value == " ms"):
            parts = arg.values[:-2]                      # drop the time and " ms"
        else:
            continue
        regex = "".join(piece(p.value) if isinstance(p, ast.Constant) else ".+?"
                        for p in parts)
        templates.append(regex.removesuffix(r"\s+"))
    return templates
