"""The interreflection pass in the port against the JAX package: the renv
branch of the colour head (``forward_color`` with 3- and 4-channel
reflection images, the roughness gate open and shut, the learned blend), the
scene renderer's hooks for the indirect pass (``geometry_only``,
``grad_ray``, ``r_images``), the three-pass ``render_scene_indirect`` with
its first-order gradients (background rays included), the roughness gate at
the scene and pretrain activation scales, and one indirect train step with
grad rays and the error map.

The model is configs/scenes/shiny3_indir.ini cut to test size (4 CP levels up
to resolution 64, rank 8, width-16 MLPs, 64 rays), with random parameters
drawn by the JAX package; the output biases of the SDF, env and renv nets
are drawn nonzero, because at an exactly-zero unitNorm feature vector the
JAX gradient is NaN (tests/test_torch_aux.py::test_zero_vector_gradient).
A random SDF is nowhere opaque, so no ray would reflect: the three-pass
render and the step run on the SDF of two spheres fitted into the small
model (:func:`sphere_scene`), the rays aimed where the big sphere mirrors the
small one, so that reflected rays hit it and the renv gate opens.
The renders and the f32 step run the CP encoder in f32 against the jitted
JAX package; the bf16 step (the production encoder) runs against JAX op by
op (trap C3).  Readings behind the tolerances: tests/indir_readings.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models import network as jnet
from envidr_tpu.models.network import init_network_params
from envidr_tpu.render.indirect import IndirectOptions as JaxIndirectOptions
from envidr_tpu.render.indirect import render_scene_indirect as jax_indirect
from envidr_tpu.render.scene import SceneRenderOptions as JaxRenderOptions
from envidr_tpu.render.scene import render_scene as jax_render
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.geometry.rays import sph_from_ray
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.render.indirect import IndirectOptions, render_scene_indirect
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer, update_error_row
from test_torch_helpers import (ROOT, camera_rays, export_jax_layout, f32_cp_encoder,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
INDIR_INI = os.path.join(ROOT, "configs", "scenes", "shiny3_indir.ini")
# shiny3_indir.ini cut to test size; its color_mlp_path points under exps/,
# which holds logs only, so the random colour MLPs stay
INDIR_SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                   hidden_dim_color=16, hidden_dim_env=16, num_rays=64, color_mlp_path="")
COLOR_ATOL = 1e-6     # colours in [0, 1], the same f32 expressions
RENDER_ATOL = 2e-4    # f32 render outputs, as tests/test_torch_render.py
GRAD1_RTOL = 1e-5     # of max: first order through the colour head alone
GRAD_RTOL = 1.3e-3    # of max: f32 double backward (ROADMAP C-5)
TERM_RTOL = 1e-4      # f32 loss terms over 64 rays
# the bf16 step against the op-by-op JAX step, as tests/test_torch_neus.py
# holds the CP step (BF16_STEP_RTOL there); readings in tests/indir_readings.py
BF16_STEP_RTOL = 2.0**-6
K, K2 = 32, 16        # the main pass's budget; the secondary one's in the renders
INDIR_EPOCH = 76      # indir_ref from 45, grad rays from 45 + 30 + 1
GLOBAL_STEP = 250
AABB = [-1.0] * 3 + [1.0] * 3


def indir_models(seed=0, **extra):
    """The JAX (opt, cfg, numpy params) and the port's (opt, cfg, net)."""
    kw = {**INDIR_SMALL, **extra}
    jopt, topt = jax_load(INDIR_INI, **kw), torch_load(INDIR_INI, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("sdf_net", "env_net", "renv_net"):
        b = params[name][-1]["b"]
        params[name][-1]["b"] = rng.uniform(-0.1, 0.1, b.shape).astype(np.float32)
    return (jopt, jcfg, params), (topt, tcfg, load_jax_params(NeRFNetwork(tcfg), params))


SPHERES = ((np.float32([0.0, 0.0, 0.0]), 0.35), (np.float32([0.62, 0.0, 0.0]), 0.22))


def _sphere_sdf(x):
    return np.min([np.linalg.norm(x - c, axis=-1) - r for c, r in SPHERES], axis=0)


_SCENE = {}


def sphere_scene(n_rays=48):
    """(numpy params of the small model with the two spheres' SDF fitted into
    it and NeuS variance 0.5, the occupancy of the cells within 0.03 of a
    surface, rays from (-0.3, 0, 2.5) at the big sphere's side that faces the
    small one).  The fit: 300 Adam steps on the port's model, once a process."""
    if not _SCENE:
        (_, _, _), (_, _, net) = indir_models(seed=8)
        adam = torch.optim.Adam(net.parameters(), lr=1e-2)
        rng = np.random.default_rng(0)
        for _ in range(300):
            centers = np.stack([c for c, _ in SPHERES])[rng.integers(0, 2, 4096)]
            x = np.concatenate([rng.uniform(-1, 1, (4096, 3)),
                                centers + rng.normal(0, 0.3, (4096, 3))]).astype(np.float32)
            pred = net.forward_geometry(torch.from_numpy(x))["sdf"]
            loss = ((pred - torch.from_numpy(_sphere_sdf(x))) ** 2).mean()
            adam.zero_grad()
            loss.backward()
            adam.step()
        with torch.no_grad():
            net.sdf_density.variance.fill_(0.5)
        H = 128
        cells = np.stack(np.meshgrid(*[np.arange(H)] * 3, indexing="ij"), -1).reshape(-1, 3)
        world = ((2.0 * cells / (H - 1) - 1.0) * (1.0 - 1.0 / H)).astype(np.float32)
        _SCENE["params"] = export_jax_layout(net)
        _SCENE["bits"] = (np.abs(_sphere_sdf(world)) < 0.03)[None]
    rng = np.random.default_rng(n_rays)
    cam = np.float32([-0.3, 0.0, 2.5])
    tgt = np.stack([rng.uniform(0.15, 0.33, n_rays), rng.uniform(-0.1, 0.1, n_rays),
                    np.full(n_rays, 0.2)], -1).astype(np.float32)
    d = tgt - cam
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (jax.tree.map(np.copy, _SCENE["params"]), _SCENE["bits"],
            np.tile(cam, (n_rays, 1)), d)


def _tree_grads(net):
    return export_jax_layout(net, grads=True)


def _leaf_errors(jgrads, net, leaves=None):
    ours = _tree_grads(net)
    errs = {}
    for leaf in leaves or jgrads:
        mine = dict(jax.tree_util.tree_leaves_with_path(ours[leaf]))
        for path, a in jax.tree_util.tree_leaves_with_path(jgrads[leaf]):
            errs[leaf + jax.tree_util.keystr(path)] = rel_err(a, mine[path])
    return errs


def test_bridge_and_network_carry_renv_and_the_blend_head():
    (_, jcfg, params), (_, tcfg, net) = indir_models(seed=1)
    assert tcfg.use_renv and tcfg.learn_indir_blend and tcfg.sdf_out_dim == 15
    assert [tuple(l.weight.shape) for l in net.renv_net] == [(64, 4), (64, 64), (64, 64),
                                                             (12, 64)]
    back = export_jax_layout(net)
    for path, a in jax.tree_util.tree_leaves_with_path(params["renv_net"]):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(
            back["renv_net"]))[path], a)
    x = np.random.default_rng(1).uniform(-0.6, 0.6, (128, 3)).astype(np.float32)
    jg = jnet.forward_geometry(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x))
    tg = net.forward_geometry(torch.from_numpy(x))
    for k in ("sdf", "roughness", "blend_weight"):
        np.testing.assert_allclose(tg[k].detach().numpy(), np.asarray(jg[k]), rtol=0, atol=1e-6)


def _color_inputs(seed, n, channels, gate_open):
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(n, 3))
    dirs = rng.normal(size=(n, 3))
    geo = rng.normal(size=(n, 12))
    r_img = rng.uniform(size=(n, channels))
    if channels == 4:      # about half the reflected rays hit the scene
        r_img[:, 3] = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.91, 1.0, n),
                               rng.uniform(0.0, 0.89, n))
    lo, hi = (0.01, 0.09) if gate_open else (0.12, 0.5)
    rough = rng.uniform(lo, hi, (n, 1))
    blend = rng.uniform(0.05, 0.95, (n, 1))
    f32 = lambda a: a.astype(np.float32)                       # noqa: E731
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    geo /= np.linalg.norm(geo, axis=-1, keepdims=True)
    return tuple(map(f32, (normals, dirs, geo, r_img, rough, blend)))


@pytest.mark.parametrize("gate_open", [True, False], ids=["gate_open", "gate_shut"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("learn_blend", [True, False], ids=["learned_blend", "rough_blend"])
def test_forward_color_renv_branch_matches(channels, gate_open, learn_blend):
    (_, jcfg, params), (_, tcfg, net) = indir_models(seed=2, learn_indir_blend=learn_blend)
    normals, dirs, geo, r_img, rough, blend = _color_inputs(3 + channels, 256, channels,
                                                            gate_open)
    cot = np.random.default_rng(9).normal(size=(256, 3)).astype(np.float32)
    bw = blend if learn_blend else None

    def jax_color(p):
        extra = jnet.get_color_mlp_extra_params(p, jcfg, jnp.asarray(normals), jnp.asarray(dirs),
                                                jnp.asarray(rough))
        col, aux = jnet.forward_color(p, jcfg, jnp.asarray(geo), jnp.asarray(dirs), *extra[:3],
                                      n_env_enc=extra[3], r_images=jnp.asarray(r_img),
                                      roughness=jnp.asarray(rough),
                                      blend_weight=None if bw is None else jnp.asarray(bw))
        return jnp.sum(col * cot), (col, aux)

    (_, (jcol, jaux)), jgrads = jax.value_and_grad(jax_color, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    t = torch.from_numpy
    extra = net.get_color_mlp_extra_params(t(normals), t(dirs), t(rough))
    col, aux = net.forward_color(t(geo), t(dirs), *extra[:3], n_env_enc=extra[3],
                                 r_images=t(r_img), roughness=t(rough),
                                 blend_weight=None if bw is None else t(bw))
    (col * t(cot)).sum().backward()
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(jcol), rtol=0, atol=COLOR_ATOL)
    mask = aux["renv_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jaux["renv_mask"]))
    np.testing.assert_allclose(aux["blend"].detach().numpy(), np.asarray(jaux["blend"]),
                               rtol=0, atol=COLOR_ATOL)
    # open: every sample (3 channels) or those whose reflection hit (4); shut: none
    assert mask.any() == gate_open and mask.all() == (gate_open and channels == 3)
    errs = _leaf_errors(jax.tree.map(np.asarray, jgrads), net,
                        ("color_net", "env_net", "renv_net", "diffuse_net"))
    assert max(errs.values()) <= GRAD1_RTOL, errs
    renv_grad = np.abs(export_jax_layout(net, grads=True)["renv_net"][0]["w"]).sum()
    assert (renv_grad > 0) == gate_open      # a shut gate gives renv_net no gradient


def _bits(kind):
    bits = np.zeros((1, 128 ** 3), bool)
    if kind == "random":
        bits = np.random.default_rng(6).uniform(size=(1, 128 ** 3)) < 0.6
    else:                  # a block in x > 0: rays aimed at x < 0 march no sample
        cube = bits.reshape(128, 128, 128)
        cube[70:110, 40:88, 40:88] = True
    return bits


def _background_rays(n=32):
    o = np.tile([[0.0, 0.0, -2.5]], (n, 1)).astype(np.float32)
    tgt = np.concatenate([np.tile([[0.45, 0.0, 0.0]], (n // 2, 1))
                          + np.random.default_rng(3).uniform(-0.1, 0.1, (n // 2, 3)),
                          np.tile([[-0.7, -0.7, 0.0]], (n - n // 2, 1))]).astype(np.float32)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _render_opts(**kw):
    base = dict(max_steps=512, num_samples=K, early_stop_steps=64, min_near=0.2,
                training=True, grid_size=128)
    base.update(kw)
    return JaxRenderOptions(**base), SceneRenderOptions(**base)


RENDER_CASES = {
    "geometry_only": dict(geometry_only=True),
    "grad_ray": dict(grad_ray=True, grad_rays_scale=0.01),
    "r_images": dict(),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_scene_indirect_hooks_match(case):
    """One pass of the scene renderer as the indirect render calls it: its
    outputs, and the gradients of a loss on them with respect to every
    parameter and (``grad_ray``) the rays' origins."""
    with f32_cp_encoder():
        (_, jcfg, params), (_, tcfg, net) = indir_models(seed=4)
    o, d = camera_rays(48, seed=5)
    bits = _bits("random")
    jo, to = _render_opts(**RENDER_CASES[case])
    r_img = None
    if case == "r_images":
        rng = np.random.default_rng(7)
        r_img = rng.uniform(size=(48, 4)).astype(np.float32)
        r_img[:, 3] = np.where(rng.uniform(size=48) < 0.6, 0.95, 0.3)
    key = "normal_image" if case == "geometry_only" else "image"
    cot = np.random.default_rng(8).normal(size=(48, 3)).astype(np.float32)

    def jax_loss(p, ro):
        out = jax_render(p, jcfg, jo, jnp.asarray(bits), ro, jnp.asarray(d), 1.0,
                         jnp.asarray(AABB), r_images=None if r_img is None else jnp.asarray(r_img))
        return jnp.sum(out[key] * cot) + jnp.sum(out["depth"]), out

    with f32_cp_encoder():
        (_, jout), (jg, jgo) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                          has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(o))
    ro = torch.from_numpy(o).requires_grad_(True)
    out = render_scene(net, to, torch.from_numpy(bits), ro, torch.from_numpy(d), 1.0,
                       torch.tensor(AABB),
                       r_images=None if r_img is None else torch.from_numpy(r_img))
    ((out[key] * torch.from_numpy(cot)).sum() + out["depth"].sum()).backward()
    assert (out.get("image") is None) == (case == "geometry_only")
    for k in (key, "depth", "weights_sum"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=RENDER_ATOL, err_msg=k)
    if case == "r_images":
        np.testing.assert_allclose(out["renv_mask_image"].detach().numpy(),
                                   np.asarray(jout["renv_mask_image"]), rtol=0, atol=RENDER_ATOL)
        assert float(out["renv_mask_image"].detach().sum()) > 0
    errs = _leaf_errors(jax.tree.map(np.asarray, jg), net)
    errs["rays_o"] = rel_err(np.asarray(jgo), ro.grad.numpy()) if ro.grad is not None else 0.0
    assert max(errs.values()) <= GRAD_RTOL, errs
    if case == "grad_ray":       # image gradients reach the origins
        assert float(ro.grad.abs().max()) > 0


@pytest.fixture(scope="module", params=["spheres", "background"])
def indirect_render(request):
    with f32_cp_encoder():
        return _indirect_render(request.param)


def _indirect_render(kind):
    (_, jcfg, params), (_, tcfg, net) = indir_models(seed=6)
    if kind == "spheres":
        params, bits, o, d = sphere_scene()
        net = load_jax_params(NeRFNetwork(tcfg), params)
    else:
        o, d = _background_rays(48)
        bits = _bits(kind)
    jo, to = _render_opts()
    ji = JaxIndirectOptions(indir_max_steps=512, indir_early_stop_steps=16,
                            indir_num_samples=K2, grad_rays=True, grad_rays_scale=0.01)
    ti = IndirectOptions(**dataclasses.asdict(ji))
    obj = np.asarray([-0.8, -0.8, -0.8, 0.8, 0.8, 0.8], np.float32)

    def jax_loss(p):
        out = jax_indirect(p, jcfg, jo, ji, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                           1.0, jnp.asarray(AABB), obj_aabb=jnp.asarray(obj))
        return jnp.mean(out["image"] ** 2) + jnp.sum(out["normal_image"]), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    out = render_scene_indirect(net, to, ti, torch.from_numpy(bits), torch.from_numpy(o),
                                torch.from_numpy(d), 1.0, torch.tensor(AABB),
                                obj_aabb=torch.from_numpy(obj))
    loss = (out["image"] ** 2).mean() + out["normal_image"].sum()
    loss.backward()
    return dict(kind=kind, jl=float(jl), jout=jout, jg=jax.tree.map(np.asarray, jg),
                tl=float(loss.detach()), out=out, net=net)


def test_render_scene_indirect_outputs_match(indirect_render):
    c = indirect_render
    out, jout = c["out"], c["jout"]
    for k in ("image", "normal_image", "depth", "weights_sum", "r_images"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=RENDER_ATOL, err_msg=k)
    for k in ("ref_mask", "ray_mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    ref = out["ref_mask"].numpy()
    assert np.all(out["r_images"].detach().numpy()[~ref] == 0.0)
    if c["kind"] == "background":        # true background rays
        assert np.any(out["weights_sum"].detach().numpy() == 0.0)
    else:                                # reflections that hit the small sphere
        np.testing.assert_allclose(out["renv_mask_image"].detach().numpy(),
                                   np.asarray(jout["renv_mask_image"]), rtol=0, atol=RENDER_ATOL)
        assert ref.any() and float(out["renv_mask_image"].detach().max()) > 0.9
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)


def test_render_scene_indirect_gradients_match_and_stay_finite(indirect_render):
    """First-order gradients of the three-pass render (through pass 1's normal
    image, the reflected rays and grad_rays); with background rays, whose
    normal image is exactly zero, every gradient stays finite
    (tests/test_indirect.py:104)."""
    c = indirect_render
    grads = _tree_grads(c["net"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
        assert np.isfinite(leaf).all(), jax.tree_util.keystr(path)
    errs = _leaf_errors(c["jg"], c["net"])
    assert max(errs.values()) <= GRAD_RTOL, errs
    assert np.abs(grads["encoder"]["proj"][0]).max() > 0


def test_render_scene_indirect_keeps_the_background_net_out_of_passes_2_and_3():
    """With ``bg_radius > 0`` and ``use_bg_net`` the reflected rays composite
    onto black and the main pass onto ``bg_color``, as in JAX, which turns
    the background net off for both (``indirect.py:92,102``): rays at the
    spheres and rays that miss everything, whose background the net would
    colour."""
    params, bits, o, d = sphere_scene()
    with f32_cp_encoder():
        (_, jcfg, drawn), (_, tcfg, _) = indir_models(seed=6, bg_radius=2.0)
        params["bg"] = drawn["bg"]
        net = load_jax_params(NeRFNetwork(tcfg), params)
    bo, bd = _background_rays(16)
    o, d = np.concatenate([o, bo]), np.concatenate([d, bd])
    jo, to = _render_opts(use_bg_net=True)
    ji = JaxIndirectOptions(indir_max_steps=512, indir_early_stop_steps=16, indir_num_samples=K2)
    ti = IndirectOptions(**dataclasses.asdict(ji))
    with f32_cp_encoder():
        jout = jax.jit(lambda p: jax_indirect(p, jcfg, jo, ji, jnp.asarray(bits), jnp.asarray(o),
                                              jnp.asarray(d), 1.0, jnp.asarray(AABB)))(
            jax.tree.map(jnp.asarray, params))
        with torch.no_grad():
            out = render_scene_indirect(net, to, ti, torch.from_numpy(bits), torch.from_numpy(o),
                                        torch.from_numpy(d), 1.0, torch.tensor(AABB))
            t_o, t_d = torch.from_numpy(o), torch.from_numpy(d)
            bg_net = net.background_color(sph_from_ray(t_o, t_d, 2.0), t_d).numpy()
    for k in ("image", "normal_image", "depth", "weights_sum", "r_images"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=RENDER_ATOL, err_msg=k)
    # the net would have coloured the rays that miss: they take bg_color
    miss = out["weights_sum"].numpy() == 0.0
    assert miss.sum() >= 4 and out["ref_mask"].numpy().any()
    assert np.abs(bg_net[miss] - 1.0).max() > 10 * RENDER_ATOL
    np.testing.assert_array_equal(out["image"].numpy()[miss], 1.0)


@pytest.mark.parametrize("scale,opens", [(0.2, True), (1.0, False)])
def test_roughness_init_opens_indir_gate_at_scene_scale(scale, opens):
    """tests/test_indirect.py's gate test in the port: the roughness head
    starts at act_scale * softplus(roughness_bias), inside the 0.1 gate at
    the scene's 0.2 (0.063) and outside at the pretrain's 1.0 (0.31)."""
    opt = torch_load(INDIR_INI, color_mlp_path="")
    assert opt.roughness_act_scale == 0.2
    cfg = dataclasses.replace(torch_netcfg(opt), roughness_act_scale=scale)
    net = NeRFNetwork(cfg, generator=torch.Generator().manual_seed(0))
    xyz = torch.from_numpy(np.random.default_rng(0).uniform(-0.8, 0.8, (256, 3)).astype(np.float32))
    rough = net.forward_geometry(xyz)["roughness"]
    inside = float((rough[..., 0] < cfg.indir_roughness_thresh).float().mean())
    assert inside > 0.9 if opens else inside < 0.1


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def indir_step(request):
    if request.param == "float32":
        with f32_cp_encoder():
            return _indir_step(jax.jit)
    with jax.disable_jit():
        return _indir_step(lambda f: f)


def _indir_step(jit):
    """One indirect train step (epoch 76: indir_ref and grad rays on, the
    error map in use) in both packages on the same rays: the loss terms, the
    gradients and the error map's EMA of the step's image error."""
    (jopt, jcfg, _), (topt, tcfg, _) = indir_models(seed=8)
    params, bits, o, d = sphere_scene(64)
    net = load_jax_params(NeRFNetwork(tcfg), params)
    rng = np.random.default_rng(10)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    alpha = pix[:, 3].copy()
    jsched = jax_resolve(jopt, INDIR_EPOCH, GLOBAL_STEP)
    assert jsched.indir_ref and jsched.grad_rays and jsched.use_error_map
    jo = JaxRenderOptions(max_steps=jsched.max_steps, num_samples=K,
                          early_stop_steps=jsched.early_stop_steps, min_near=jopt.min_near,
                          training=True, cos_anneal_ratio=jsched.cos_anneal_ratio)
    ji = JaxIndirectOptions(indir_max_steps=jopt.indir_max_steps,
                            indir_early_stop_steps=jopt.indir_early_stop_steps,
                            indir_num_samples=min(K, max(jopt.indir_early_stop_steps, 16)),
                            grad_rays=True, grad_rays_scale=jopt.grad_rays_scale)
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}

    def loss_fn(p):
        out = jax_indirect(p, jcfg, jo, ji, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(bg), jnp.asarray(AABB),
                           cos_anneal_ratio=weights["_cos_anneal"])
        inv_s = jnp.clip(jnp.exp(p["sdf_density"]["variance"] * 10.0), 1e-6, 1e6)
        total, terms = compute_losses(out, jnp.asarray(gt), jsched.flags, weights,
                                      neus_inv_s=inv_s, alpha_mask=jnp.asarray(alpha))
        return total, (out, terms)

    (jl, (jout, jterms)), jgrads = jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    # the error map's EMA with repeated cells, as the JAX step writes it
    ic = rng.integers(0, 40, 64)
    row = rng.uniform(0.05, 0.2, 128 * 128).astype(np.float32)
    err = jnp.mean(jnp.abs(jout["image"] - jnp.asarray(gt)), axis=-1)
    jrow = jnp.asarray(row).at[ic].set(0.9 * jnp.take(jnp.asarray(row), ic) + 0.1 * err)

    tr = Trainer(topt, tcfg, device="cpu", net=net)
    tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
    sched = resolve(topt, INDIR_EPOCH, GLOBAL_STEP)
    assert tr.indirect_options(K, sched).indir_num_samples == ji.indir_num_samples == K
    tl, out, tterms = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, alpha)),
                                      K=K, sched=sched)
    tl.backward()
    terr = (out["image"].detach() - torch.from_numpy(gt)).abs().mean(dim=-1)
    trow = update_error_row(torch.from_numpy(row), torch.from_numpy(ic), terr)
    return dict(jl=float(jl), jterms=jterms, jgrads=jax.tree.map(np.asarray, jgrads), tr=tr,
                tl=float(tl.detach()), tterms=tterms, out=out, jout=jout, jrow=np.asarray(jrow),
                trow=trow.numpy(), dtype=tcfg.cp_spec.compute_dtype, ic=ic)


def test_indir_step_loss_terms_match(indir_step):
    c = indir_step
    assert set(c["tterms"]) == set(c["jterms"]) == {"color", "mask", "eikonal"}
    for k, v in c["jterms"].items():
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)
    assert bool(c["out"]["renv_mask"].any())          # the renv gate opens


@pytest.mark.parametrize("leaf", ["encoder", "sdf_density", "sdf_net", "diffuse_net",
                                  "color_net", "env_net", "renv_net"])
def test_indir_step_gradients_match(indir_step, leaf):
    c = indir_step
    tol = GRAD_RTOL if c["dtype"] == "float32" else BF16_STEP_RTOL
    errs = _leaf_errors(c["jgrads"], c["tr"].net, (leaf,))
    assert max(errs.values()) <= tol, errs


def test_indir_step_error_map_ema_matches(indir_step):
    """The EMA of the step's per-ray error into the error map, with cells
    drawn by several rays: the last ray wins in both (the JAX scatter on the
    CPU; the port by the amax of the ray index)."""
    c = indir_step
    assert len(np.unique(c["ic"])) < len(c["ic"])
    np.testing.assert_allclose(c["trow"], c["jrow"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", [("specular", "diffuse", "renv"), ("all",)],
                         ids=["renv", "all"])
def test_resume_mlps_renv_and_all_match_jax(which, tmp_path):
    """``resume_mlps`` with ``renv`` (the renv pretrain's three nets, as the
    interreflection configs load them; renv_net left trainable) and ``all``
    (every module of a donor one size smaller: each leaf fills the leading
    corner of the current one, as ``_merge_tolerant`` does) against the JAX
    trainer."""
    import pickle

    from envidr_tpu.train.trainer import Trainer as JaxTrainer

    path = os.path.join(ROOT, "assets", "renv_pretrain_best.ckpt")
    extra = dict(hidden_dim_color=64)
    if which == ("all",):
        (_, _, donor), _ = indir_models(seed=11, hidden_dim=12, hidden_dim_env=12)
        donor["sdf_density"]["variance"] = np.float32(0.45)
        path = str(tmp_path / "donor.ckpt")
        with open(path, "wb") as f:
            pickle.dump({"params": donor}, f)
        extra = {}
    (jopt, jcfg, params), (topt, tcfg, net) = indir_models(
        seed=12, color_mlp_path=path, resume_mlps=which, **extra)
    jt = JaxTrainer(jopt, jcfg, params=jax.tree.map(jnp.asarray, params),
                    workspace=str(tmp_path))
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    ours, ema = export_jax_layout(tr.net), export_jax_layout(tr.ema_net)
    for a, b, what in ((ours, jt.state["params"], "params"), (ema, jt.state["ema"], "ema")):
        la = jax.tree_util.tree_leaves_with_path(a)
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert {p for p, _ in la} == set(lb), what
        for p, x in la:
            np.testing.assert_array_equal(x, np.asarray(lb[p]), err_msg=f"{what} {p}")
    assert tr.optimizer.frozen_names == frozenset({"color_net", "diffuse_net"})
    moved = {n for n in ours if any(not np.array_equal(x, y) for x, y in zip(
        jax.tree.leaves(ours[n]), jax.tree.leaves(params[n])))}
    want = ({"color_net", "diffuse_net", "renv_net"} if which != ("all",)
            else {"encoder", "sdf_density", "sdf_net", "diffuse_net", "color_net", "env_net",
                  "renv_net"})
    assert moved == want
