"""The network options of the scene runtime in the port against the JAX
package, at small size (``configs/synth_spheres_cp_laplace.ini`` cut to 4
CP levels of rank 8 and width-16 MLPs, the CP encoder in f32, the JAX side
jitted); the march, the ray samplers and ``render_env_on_sphere`` are
``tests/test_torch_runtime_samplers.py``:

* the geometric (sphere) init with softplus(100) between the SDF layers,
  numerical normals, a roughness head on ``geo_feat`` without the ensemble
  SDF net, a diffuse env net of its own (``split_diffuse_env``) and the
  background net (``bg_radius > 0``): one scene render's outputs and the
  gradients of its image and eikonal terms; the background colour alone,
  through the hashed level of its 2-D table;
* the full-model ``.pth`` import of ``roughness_layer``,
  ``diffuse_env_net``, ``bg_net`` and the stacked ``env_nets``;
* ``skip_layers``, which the JAX package's own SDF net cannot run.

Tolerances from readings of these cases on the CPU, each beside its bound."""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models import network as jnet
from envidr_tpu.render.scene import SceneRenderOptions as JaxSceneOptions
from envidr_tpu.render.scene import render_scene as jax_render_scene
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.io import torch_import
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (CP_LAPLACE_INI, CP_SMALL, ROOT, camera_rays, export_jax_layout,
                                f32_cp_encoder, fitted_model, one_torch_thread_fixture,
                                rel_err)

one_torch_thread = one_torch_thread_fixture()
# readings of the option renders on the CPU (the SDF fitted to radius 0.7):
# outputs 6.2e-6 at most, 3.1e-5 with numerical normals (the SDF gradients:
# central differences over 0.01 lose ~6 ulp of the SDF's value); gradients
# 1.0e-5 of a leaf's max, 3.1e-4 with the geometric init (an SDF-net bias
# under softplus(100)); the background colour and its table gradient below
# BG_ATOL's reading; each bound ~8x its reading
IMAGE_ATOL = {"numerical_normals": 2.5e-4}
GRAD_RTOL = {"geometric_init": 2.5e-3}
DEFAULT_ATOL, DEFAULT_RTOL = 5e-5, 1e-4
BG_ATOL = 1e-6
OPTIONS = {
    "geometric_init": dict(geometric_init=True),
    "numerical_normals": dict(numerical_normals=True),
    "roughness_layer": dict(ensemble_mlp=False),
    "split_diffuse_env": dict(split_diffuse_env=True, sh_degree_diffuse=2,
                              hidden_dim_env_diffuse=8),
    "bg_net": dict(bg_radius=2.0),
}
AABB = np.asarray([-1.0] * 3 + [1.0] * 3, np.float32)


def option_model(seed: int = 0, fitted=None, **extra):
    """JAX (opt, cfg, params as numpy) and the port's (opt, cfg, net) of the
    small config with ``extra``, equal weights (JAX's draws carried across).
    ``fitted``, a fitted model's params, replaces the encoder, the density
    and the SDF net's leading corner (an SDF net of fewer outputs keeps the
    SDF and the geometry feature, its first outputs)."""
    kw = {**CP_SMALL, **extra}
    jopt, topt = jax_load(CP_LAPLACE_INI, **kw), torch_load(CP_LAPLACE_INI, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = jax.tree.map(np.asarray, jnet.init_network_params(jax.random.PRNGKey(seed), jcfg))
    if fitted is not None:
        params["encoder"], params["sdf_density"] = fitted["encoder"], fitted["sdf_density"]
        params["sdf_net"] = [{k: v[tuple(slice(0, n) for n in own[k].shape)]
                              for k, v in layer.items()}
                             for layer, own in zip(fitted["sdf_net"], params["sdf_net"])]
    return (jopt, jcfg, params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg), params))


def _option_render(option: str):
    """The option's model on one SDF fitted to radius 0.7, but the geometric
    init's own, a sphere from its draw."""
    fitted = None
    if option != "geometric_init":
        fitted = fitted_model(seed=1, radius=0.7, steps=60)[0][2]
    (_, jcfg, params), (_, tcfg, net) = option_model(seed=1, fitted=fitted, **OPTIONS[option])
    o, d = camera_rays(32, seed=2)
    bits = np.random.default_rng(3).uniform(size=(1, 128 ** 3)) < 0.6
    kw = dict(max_steps=512, num_samples=16, early_stop_steps=16, T_thresh=1e-4,
              min_near=0.2, training=True)
    bg_net = option == "bg_net"

    def jloss(p):
        out = jax_render_scene(p, jcfg, JaxSceneOptions(**kw, use_bg_net=bg_net),
                               jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d), 1.0,
                               jnp.asarray(AABB))
        g = out["sdf_gradients"]
        eik = jnp.mean((jnp.linalg.norm(g + 1e-12, axis=-1) - 1.0) ** 2)
        return jnp.mean(out["image"]) + 0.1 * eik, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    out = render_scene(net, SceneRenderOptions(**kw, use_bg_net=bg_net), torch.from_numpy(bits),
                       torch.from_numpy(o), torch.from_numpy(d), 1.0, torch.from_numpy(AABB))
    g = out["sdf_gradients"]
    eik = ((torch.linalg.vector_norm(g + 1e-12, dim=-1) - 1.0) ** 2).mean()
    (out["image"].mean() + 0.1 * eik).backward()
    return dict(ref=ref, jgrads=jax.tree.map(np.asarray, jgrads), out=out, net=net,
                grads=export_jax_layout(net, grads=True))


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def option_render(request):
    with f32_cp_encoder():
        return request.param, _option_render(request.param)


def test_option_render_matches_jax(option_render):
    option, c = option_render
    ref, out = c["ref"], c["out"]
    keys = ["image", "depth", "weights_sum", "normal_image", "sdf_gradients",
            "roughness_image", "diffuse_image"] + (["sphere_bg"] if option == "bg_net" else [])
    for k in keys:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=IMAGE_ATOL.get(option, DEFAULT_ATOL), err_msg=k)
    assert int(out["counts"].sum()) > 0
    names = {n for n, _ in c["net"].named_children()}
    assert names == set(c["jgrads"])
    extra = {"roughness_layer": "roughness_layer", "split_diffuse_env": "diffuse_env_net",
             "bg_net": "bg"}.get(option)
    assert extra is None or extra in names


def test_option_gradients_match_jax(option_render):
    option, c = option_render
    flat = dict(jax.tree_util.tree_leaves_with_path(c["grads"]))
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(c["jgrads"]):
        if np.abs(a).max() == 0:
            np.testing.assert_array_equal(flat[path], 0.0)
            continue
        errs[jax.tree_util.keystr(path)] = rel_err(a, flat[path])
    assert max(errs.values()) <= GRAD_RTOL.get(option, DEFAULT_RTOL), errs
    moved = {"roughness_layer": "['roughness_layer']['w']",
             "split_diffuse_env": "['diffuse_env_net'][0]['w']",
             "bg_net": "['bg']['encoder']['embeddings']"}.get(option)
    assert moved is None or moved in errs        # the option's own leaf takes a gradient


def test_background_color_matches_jax_on_every_level():
    """Points over the whole background sphere: level 3 of the 2-D table
    (2048^2 cells in 2^19 rows) is hashed, the others dense."""
    (_, jcfg, params), (_, _, net) = option_model(seed=4, bg_radius=2.0)
    rng = np.random.default_rng(5)
    sph = rng.uniform(-1.0, 1.0, (256, 2)).astype(np.float32)
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = jax.tree.map(jnp.asarray, params)
    emb = rng.uniform(-0.1, 0.1, params["bg"]["encoder"]["embeddings"].shape).astype(np.float32)
    p["bg"]["encoder"]["embeddings"] = jnp.asarray(emb)
    with torch.no_grad():
        net.bg.encoder.embeddings.copy_(torch.from_numpy(emb))
    ref, vjp = jax.vjp(lambda e: jnet.background_color(
        {**p, "bg": {**p["bg"], "encoder": {"embeddings": e}}}, jcfg, jnp.asarray(sph),
        jnp.asarray(dirs)), jnp.asarray(emb))
    cot = rng.normal(size=(256, 3)).astype(np.float32)
    ours = net.background_color(torch.from_numpy(sph), torch.from_numpy(dirs))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=BG_ATOL)
    ours.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(net.bg.encoder.embeddings.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), rtol=0, atol=BG_ATOL)
    assert tuple(net.bg.encoder.embeddings.shape) == (696754, 2)


def test_skip_layers_fails_in_jax_and_the_port_refuses_it():
    (_, jcfg, _), (_, tcfg, _) = option_model()
    import dataclasses
    jcfg = dataclasses.replace(jcfg, skip_layers=(1,))
    p = jnet.init_network_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(TypeError, match="dot_general"):
        jnet.geometry_with_normals(p, jcfg, jnp.zeros((4, 3)))
    with pytest.raises(NotImplementedError, match="skip_layers"):
        NeRFNetwork(dataclasses.replace(tcfg, skip_layers=(1,)))


# ------------------------------------------------------------- .pth import

def test_pth_import_of_the_new_keys_matches_jax(tmp_path):
    """A full-model state dict with the stacked env nets, the roughness head,
    a diffuse env net and a background MLP: both packages read the same
    pytree, the background MLP under ``bg_net`` (not the network's ``bg``),
    so that resuming ``all`` leaves the background net as it was."""
    from envidr_tpu.io import torch_import as jimport
    rng = np.random.default_rng(10)

    def linear(prefix, i, o, bias=True):
        out = {f"{prefix}.weight": torch.tensor(rng.normal(size=(o, i)), dtype=torch.float32)}
        if bias:
            out[f"{prefix}.bias"] = torch.tensor(rng.normal(size=o), dtype=torch.float32)
        return out

    sd = {}
    for e in range(3):
        sd.update(linear(f"env_nets.{e}.0", 5, 8))
        sd.update(linear(f"env_nets.{e}.1", 8, 4))
    sd.update(linear("roughness_layer", 12, 1))
    sd.update(linear("diffuse_env_net.0", 9, 8))
    sd.update(linear("diffuse_env_net.1", 8, 12))
    sd.update(linear("bg_net.0", 40, 64, bias=False))
    sd.update(linear("bg_net.1", 64, 3, bias=False))
    path = str(tmp_path / "model.pth")
    torch.save({"model": sd}, path)
    ours = torch_import.network_params_from_state(torch_import.load_state_dict(path))
    (_, jcfg, _), _ = option_model()
    ref = jax.tree.map(np.asarray, jimport.network_params_from_state(
        jimport.load_state_dict(path), jcfg))
    assert set(ours) == set(ref) == {"env_nets", "roughness_layer", "diffuse_env_net", "bg_net"}
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves_with_path(ours)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(b), a)
    assert ours["env_nets"][0]["w"].shape == (3, 5, 8)
    # resuming all: the roughness head and the diffuse env net (of another
    # depth: taken as they are) load as in JAX; the background net stays as drawn
    kw = dict(CP_SMALL, bg_radius=2.0, ensemble_mlp=False, split_diffuse_env=True,
              color_mlp_path=path, resume_mlps=("all",))
    jopt = jax_load(CP_LAPLACE_INI, workspace=str(tmp_path), **kw)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
    opt = torch_load(CP_LAPLACE_INI, **kw)
    tcfg = torch_netcfg(opt)
    drawn = NeRFNetwork(tcfg, generator=torch.Generator().manual_seed(opt.seed))
    tr = Trainer(opt, tcfg, device="cpu")
    got = export_jax_layout(tr.net)
    for name in ("roughness_layer", "diffuse_env_net"):
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                 jt.state["params"][name])),
                jax.tree_util.tree_leaves_with_path(got[name])):
            assert pa == pb
            np.testing.assert_array_equal(b, a)
    assert len(tr.net.diffuse_env_net) == 2 and "bg_net" not in jt.state["params"]
    for a, b in zip(drawn.bg.parameters(), tr.net.bg.parameters()):
        assert torch.equal(a, b)
