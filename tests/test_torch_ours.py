"""ENVIDR's per-scene recipe (configs/scenes/synth_spheres_ours.ini) in the
port against the JAX package: the rendering MLPs loaded from the pretrain
checkpoint (``color_mlp_path`` / ``resume_mlps``, with the tolerant merge of
a smaller donor), frozen in the optimizer (``frozen_mlps``), one train step,
and relighting by swapping the env net (``swap_env_net``).

The config is cut to test size (4 CP levels up to resolution 64, rank 8, a
width-16 SDF net, 64 rays); the rendering MLPs keep the pretrain's interface
widths (colour 28 -> 64 -> 64 -> 3, diffuse 24 -> 32 -> 3) so that the
checkpoint drops in.  The step runs its CP encoder in f32, held against the
jitted JAX step (trap C3)."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.models.network import init_network_params
from envidr_tpu.render.scene import SceneRenderOptions as JaxRenderOptions
from envidr_tpu.render.scene import render_scene as jax_render
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.render.scene import SceneRenderOptions, render_scene
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (ROOT, camera_rays, export_jax_layout, f32_cp_encoder,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
OURS_INI = os.path.join(ROOT, "configs", "scenes", "synth_spheres_ours.ini")
PRETRAIN = os.path.join(ROOT, "assets", "env_sphere_pretrain_best.ckpt")
ENV5 = os.path.join(ROOT, "assets", "env_ckpts", "env_net_5.pth")
OURS_SMALL = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                  num_rays=64, color_mlp_path=PRETRAIN)
FROZEN = ("color_net", "diffuse_net")
TRAINABLE = ("encoder", "sdf_density", "sdf_net", "env_net")
TERM_RTOL = 1e-4     # f32 loss terms over 64 rays x 32 samples
GRAD_RTOL = 1.3e-3   # f32 double backward, rel. to max (ROADMAP C-5)
# the 160-wide env net's first two weight gradients: two of its hidden
# pre-activations lie within 3e-8 of zero and flip their ReLU between f32 and
# f64, so one sample's share of the gradient comes and goes.  Readings
# (tests/ours_readings.py): port f32 against port f64 1.61e-3, JAX f32
# against port f64 2.9e-4, port against JAX 1.61e-3; 5e-3 leaves 3x room.
RELU_FLIP_RTOL = 5e-3
RENDER_ATOL = 2e-4   # f32 eval render, as tests/test_torch_render.py
K = 32
GLOBAL_STEP = 250    # cos_anneal_ratio 0.5 at cos_anneal_steps 500


def _models(tmp_path, seed=0, **extra):
    """The JAX trainer and the port's trainer of the small ours config, from
    the same initial parameters; both load the checkpoint's MLPs."""
    kw = {**OURS_SMALL, **extra}
    jopt, topt = jax_load(OURS_INI, workspace=str(tmp_path), **kw), torch_load(OURS_INI, **kw)
    jcfg, tcfg = jax_netcfg(jopt), torch_netcfg(topt)
    params = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(seed), jcfg))
    jt = JaxTrainer(jopt, jcfg, params=jax.tree.map(jnp.asarray, params),
                    workspace=str(tmp_path))
    tr = Trainer(topt, tcfg, device="cpu", net=load_jax_params(NeRFNetwork(tcfg), params))
    return jt, tr, params


def _ckpt_mlps(path=PRETRAIN):
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload.get("ema", payload["params"])


def _assert_tree_equal(a, b, what):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what} {path}")


def test_resume_mlps_match_jax_and_the_checkpoint(tmp_path):
    jt, tr, params = _models(tmp_path)
    ckpt = _ckpt_mlps()
    ours, ema = export_jax_layout(tr.net), export_jax_layout(tr.ema_net)
    for name in FROZEN:
        _assert_tree_equal(ours[name], jt.state["params"][name], name)
        _assert_tree_equal(ours[name], ckpt[name], name)
        _assert_tree_equal(ema[name], jt.state["ema"][name], f"ema {name}")
    for name in TRAINABLE:                       # untouched by the resume
        _assert_tree_equal(ours[name], params[name], name)
    assert {n for n, _ in tr.net.named_children() if n in FROZEN} == set(FROZEN)
    assert tr.optimizer.frozen_names == frozenset(FROZEN)
    assert {id(p) for p in tr.optimizer.frozen} == {
        id(p) for n in FROZEN for p in getattr(tr.net, n).parameters()}


def _donor(tmp_path, kind):
    """A checkpoint whose MLPs the merge must embed or take as they are:
    ``smaller`` (colour hidden 48 and diffuse hidden 16 in 64- and 32-wide
    nets: the leading corner), ``deeper`` (a 3-layer diffuse net: another
    structure, taken as it is) and ``pth`` (a reference state dict)."""
    rng = np.random.default_rng(1)

    def mlp(dims):
        return [{"w": rng.standard_normal((a, b)).astype(np.float32),
                 "b": rng.standard_normal(b).astype(np.float32)} for a, b in zip(dims, dims[1:])]

    color = mlp([28, 48, 48, 3]) if kind != "deeper" else mlp([28, 64, 64, 3])
    diffuse = mlp([24, 16, 3]) if kind != "deeper" else mlp([24, 32, 32, 3])
    if kind == "pth":
        sd = {f"{name}.{i}.{k}": torch.from_numpy(np.ascontiguousarray(
            layer["w"].T if k == "weight" else layer["b"]))
            for name, layers in (("color_net", color), ("diffuse_net", diffuse))
            for i, layer in enumerate(layers) for k in ("weight", "bias")}
        path = str(tmp_path / "donor.pth")
        torch.save({"model": sd}, path)
        return path
    path = str(tmp_path / "donor.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": {"color_net": color, "diffuse_net": diffuse}}, f)
    return path


@pytest.mark.parametrize("kind", ["smaller", "deeper", "pth"])
def test_merge_tolerant_donors_match_jax(tmp_path, kind):
    jt, tr, params = _models(tmp_path, seed=2, color_mlp_path=_donor(tmp_path, kind))
    ours = export_jax_layout(tr.net)
    for name in FROZEN:
        _assert_tree_equal(ours[name], jt.state["params"][name], name)
        _assert_tree_equal(export_jax_layout(tr.ema_net)[name], jt.state["ema"][name], name)
    if kind == "smaller":          # the corner outside the donor keeps the init
        w0 = ours["color_net"][1]["w"]
        np.testing.assert_array_equal(w0[48:, :], params["color_net"][1]["w"][48:, :])
        assert not np.array_equal(w0[:48, :48], params["color_net"][1]["w"][:48, :48])
    if kind == "deeper":
        assert len(tr.net.diffuse_net) == 3
        assert {id(p) for p in tr.optimizer.frozen} >= {id(p) for p in tr.net.diffuse_net.parameters()}


def test_unported_resume_names_raise(tmp_path):
    """Where the JAX trainer skips a resume name silently, the port raises:
    ``diffuse_env`` without ``split_diffuse_env`` (the network has no
    ``diffuse_env_net``), ``specular_env`` from the pretrain (which holds
    the stack ``env_nets`` only), and a name of neither package."""
    for which, name in ((("diffuse_env",), "diffuse_env_net"), (("specular_env",), "env_net"),
                        (("speculr",), "speculr")):
        opt = torch_load(OURS_INI, **{**OURS_SMALL, "resume_mlps": which})
        with pytest.raises(ValueError, match=name):
            Trainer(opt, torch_netcfg(opt), device="cpu")


def test_resume_of_the_split_env_nets_matches_jax(tmp_path):
    """``split_diffuse_env``: ``diffuse_env`` loads ``diffuse_env_net`` and
    ``specular_env`` loads ``env_net`` from a checkpoint, beside the
    pretrain's frozen colour MLPs, in the net and its EMA, as in JAX."""
    kw = dict(split_diffuse_env=True, hidden_dim_env=32)
    jopt = jax_load(OURS_INI, workspace=str(tmp_path), **OURS_SMALL, **kw)
    donor = jax.tree.map(np.asarray, init_network_params(jax.random.PRNGKey(9), jax_netcfg(jopt)))
    path = str(tmp_path / "envs.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": {k: donor[k] for k in ("env_net", "diffuse_env_net")}}, f)
    which = dict(kw, color_mlp_path=path, resume_mlps=("diffuse_env", "specular_env"))
    jt, tr, params = _models(tmp_path, seed=3, **which)
    for name in ("env_net", "diffuse_env_net"):
        _assert_tree_equal(export_jax_layout(tr.net)[name], donor[name], name)
        _assert_tree_equal(export_jax_layout(tr.ema_net)[name], jt.state["ema"][name], name)
        _assert_tree_equal(jt.state["params"][name], donor[name], name)
    assert {id(p) for p in tr.net.diffuse_env_net.parameters()} <= \
        {id(p) for p in tr.optimizer.params}                 # the env group: it trains


@pytest.fixture(scope="module")
def frozen_step(tmp_path_factory):
    with f32_cp_encoder():
        return _frozen_step(tmp_path_factory.mktemp("ours"))


def _frozen_step(tmp_path):
    jt, tr, _ = _models(tmp_path, seed=5)
    jopt, jcfg = jt.opt, jt.cfg
    o, d = camera_rays(64, seed=4)
    rng = np.random.default_rng(5)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    alpha = pix[:, 3].copy()
    bits = np.random.default_rng(6).uniform(size=(1, 128 ** 3)) < 0.6
    jsched = jax_resolve(jopt, 1, GLOBAL_STEP)
    ropts = JaxRenderOptions(max_steps=jsched.max_steps, num_samples=K,
                             early_stop_steps=jsched.early_stop_steps, dt_gamma=jopt.dt_gamma,
                             T_thresh=jopt.T_thresh, min_near=jopt.min_near, training=True,
                             cos_anneal_ratio=jsched.cos_anneal_ratio)
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}

    def loss_fn(p):
        out = jax_render(p, jcfg, ropts, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(bg), jnp.asarray([-1.0] * 3 + [1.0] * 3),
                         cos_anneal_ratio=weights["_cos_anneal"])
        inv_s = jnp.clip(jnp.exp(p["sdf_density"]["variance"] * 10.0), 1e-6, 1e6)
        return compute_losses(out, jnp.asarray(gt), jsched.flags, weights,
                              neus_inv_s=inv_s, alpha_mask=jnp.asarray(alpha))

    jparams = jt.state["params"]
    (jl, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    updates, jstate = jt.optimizer.update(jgrads, jt.state["opt_state"], jparams)
    jnew = optax.apply_updates(jparams, updates)

    tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
    before = jax.tree.map(np.copy, export_jax_layout(tr.net))    # not views of the params
    tl, out, tterms = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, alpha)),
                                      K=K, sched=resolve(tr.opt, 1, GLOBAL_STEP))
    tl.backward()
    tgrads = export_jax_layout(tr.net, grads=True)
    tr._apply_update()
    return dict(jl=float(jl), jterms=jterms, jgrads=jax.tree.map(np.asarray, jgrads),
                jparams=jax.tree.map(np.asarray, jparams), jnew=jax.tree.map(np.asarray, jnew),
                jnotfinite=int(jstate.notfinite_count), tl=float(tl.detach()), tterms=tterms,
                tgrads=tgrads, before=before, after=export_jax_layout(tr.net),
                ema=export_jax_layout(tr.ema_net), tr=tr, counts=int(out["counts"].sum()))


def test_frozen_step_loss_terms_match(frozen_step):
    c = frozen_step
    assert set(c["tterms"]) == set(c["jterms"]) == {"color", "mask", "eikonal"}
    for k, v in c["jterms"].items():
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)
    assert c["counts"] > 0


@pytest.mark.parametrize("leaf", TRAINABLE + FROZEN)
def test_frozen_step_gradients_match(frozen_step, leaf):
    """Every gradient, the frozen nets' too: they are computed (their
    finiteness gates the step) but not applied."""
    ours = dict(jax.tree_util.tree_leaves_with_path(frozen_step["tgrads"][leaf]))
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(frozen_step["jgrads"][leaf]):
        assert np.abs(a).max() > 0, path
        errs[jax.tree_util.keystr(path)] = rel_err(a, ours[path])
    assert max(errs.values()) <= (RELU_FLIP_RTOL if leaf == "env_net" else GRAD_RTOL), errs


def test_frozen_leaves_bit_unchanged_and_trainable_leaves_move(frozen_step):
    c = frozen_step
    ckpt = _ckpt_mlps()
    assert c["jnotfinite"] == 0 and int(c["tr"].notfinite) == 0
    for name in FROZEN:
        _assert_tree_equal(c["jnew"][name], c["jparams"][name], f"JAX {name}")
        _assert_tree_equal(c["after"][name], ckpt[name], f"port {name}")
        _assert_tree_equal(c["ema"][name], ckpt[name], f"port EMA {name}")
    for name in TRAINABLE:
        for x, y in ((c["jnew"][name], c["jparams"][name]), (c["after"][name], c["before"][name])):
            assert any(not np.array_equal(a, b) for a, b in
                       zip(jax.tree_util.tree_leaves(x), jax.tree_util.tree_leaves(y))), name


def _torch_layout_grads(net, grads):
    with torch.no_grad():
        for (name, p), (_, g) in zip(net.named_parameters(), _named_leaves(grads, net)):
            p.grad = torch.tensor(np.array(g, np.float32))


def _named_leaves(tree, net):
    """(parameter name, leaf in the torch layout) in ``net``'s order."""
    flat = {}
    for top, sub in tree.items():
        for path, a in jax.tree_util.tree_leaves_with_path(sub):
            keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
            if keys[-1] == "w":
                flat[".".join([top, *keys[:-1], "weight"])] = np.asarray(a).T
            elif keys[-1] == "b":
                flat[".".join([top, *keys[:-1], "bias"])] = np.asarray(a)
            else:
                flat[".".join([top, *keys])] = np.asarray(a)
    return [(n, flat[n]) for n, _ in net.named_parameters()]


@pytest.mark.parametrize("case", ["finite", "nan_in_frozen"])
def test_frozen_update_matches_optax(tmp_path, case):
    """Two updates on the same gradients: the frozen group takes none, the
    others take optax's (the tolerances of
    tests/test_torch_train_step.py::test_optimizer_update_matches_optax).  A
    NaN in a frozen net's gradient skips the whole step in both."""
    jt, tr, _ = _models(tmp_path, seed=8)
    rng = np.random.default_rng(9)
    jp = jt.state["params"]
    grads = [jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), jp)
             for _ in range(2)]
    if case == "nan_in_frozen":
        grads[1]["color_net"][0]["w"][0, 0] = np.nan
    state = jt.state["opt_state"]
    for g in grads:
        upd, state = jt.optimizer.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    start = jax.tree.map(np.copy, export_jax_layout(tr.net))
    for g in grads:
        _torch_layout_grads(tr.net, g)
        tr._apply_update()
    ours = export_jax_layout(tr.net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp)),
                                 jax.tree_util.tree_leaves_with_path(ours)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=str(path))
    for name in FROZEN:
        _assert_tree_equal(ours[name], start[name], name)
    skipped = int(case == "nan_in_frozen")
    assert int(state.total_notfinite) == skipped == int(tr.notfinite)
    assert int(tr.applied_steps) == 2 - skipped


@pytest.mark.parametrize("hidden_env", [160, 16])
def test_swap_env_net_render_matches_jax(tmp_path, hidden_env):
    """Relighting with env_net_5.pth: at the config's 160 width the weights
    are copied in place, at 16 the module is replaced; either way the
    render agrees with JAX's pixel by pixel, and the EMA net holds the same
    env net."""
    with f32_cp_encoder():
        jt, tr, _ = _models(tmp_path, seed=11, hidden_dim_env=hidden_env)
        o, d = camera_rays(64, seed=12)
        bits = np.random.default_rng(13).uniform(size=(1, 128 ** 3)) < 0.6
        aabb = np.asarray([-1.0] * 3 + [1.0] * 3, np.float32)
        kw = dict(max_steps=512, num_samples=K, early_stop_steps=64, T_thresh=1e-4,
                  min_near=0.2)

        def ours():
            with torch.no_grad():
                return render_scene(tr.ema_net, SceneRenderOptions(**kw), torch.from_numpy(bits),
                                    torch.from_numpy(o), torch.from_numpy(d), 1.0,
                                    torch.from_numpy(aabb))["image"].numpy()

        before = ours()
        env_params = [id(p) for p in tr.net.env_net.parameters()]
        jt.swap_env_net(ENV5)
        tr.swap_env_net(ENV5)
        ref = jax.jit(lambda p: jax_render(p, jt.cfg, JaxRenderOptions(**kw), jnp.asarray(bits),
                                           jnp.asarray(o), jnp.asarray(d), 1.0,
                                           jnp.asarray(aabb))["image"])(jt.state["ema"])
        after = ours()
    np.testing.assert_allclose(after, np.asarray(ref), rtol=0, atol=RENDER_ATOL)
    assert np.abs(after - before).mean() > 1e-3
    for net in (tr.net, tr.ema_net):
        _assert_tree_equal(export_jax_layout(net)["env_net"], jt.state["params"]["env_net"],
                           "env_net")
    assert not any(p.requires_grad for p in tr.ema_net.parameters())
    same = [id(p) for p in tr.net.env_net.parameters()] == env_params
    assert same == (hidden_env == 160)
    assert {id(p) for p in tr.net.env_net.parameters()} <= {id(p) for p in tr.optimizer.params}
    # without a diffuse env net, split_diffuse swaps the env net alone, as in JAX
    jt.swap_env_net(ENV5, split_diffuse=True)
    tr.swap_env_net(ENV5, split_diffuse=True)
    assert not hasattr(tr.net, "diffuse_env_net") and "diffuse_env_net" not in jt.state["params"]
    _assert_tree_equal(export_jax_layout(tr.net)["env_net"], jt.state["params"]["env_net"],
                       "env_net")


def test_split_relight_matches_jax(tmp_path):
    """``swap_env_net(split_diffuse=True)`` under ``split_diffuse_env``: the
    old env net becomes the diffuse env net and the file's the env net, in
    the net and the EMA net; the relit render agrees with JAX's, whose
    diffuse colour now reads the old env net."""
    with f32_cp_encoder():
        jt, tr, _ = _models(tmp_path, seed=21, split_diffuse_env=True)
        old = jax.tree.map(np.copy, export_jax_layout(tr.net)["env_net"])
        old_ema = jax.tree.map(np.copy, export_jax_layout(tr.ema_net)["env_net"])
        jt.swap_env_net(ENV5, split_diffuse=True)
        tr.swap_env_net(ENV5, split_diffuse=True)
        new = [{k: np.asarray(v) for k, v in layer.items()}
               for layer in jt.state["params"]["env_net"]]
        for net, before, state in ((tr.net, old, "params"), (tr.ema_net, old_ema, "ema")):
            ours = export_jax_layout(net)
            _assert_tree_equal(ours["diffuse_env_net"], before, "diffuse_env_net")
            _assert_tree_equal(ours["env_net"], new, "env_net")
            _assert_tree_equal(ours["diffuse_env_net"], jt.state[state]["diffuse_env_net"],
                               "diffuse_env_net")
        o, d = camera_rays(64, seed=22)
        bits = np.random.default_rng(23).uniform(size=(1, 128 ** 3)) < 0.6
        aabb = np.asarray([-1.0] * 3 + [1.0] * 3, np.float32)
        kw = dict(max_steps=512, num_samples=K, early_stop_steps=64, T_thresh=1e-4,
                  min_near=0.2)
        ref = jax.jit(lambda p: jax_render(p, jt.cfg, JaxRenderOptions(**kw), jnp.asarray(bits),
                                           jnp.asarray(o), jnp.asarray(d), 1.0,
                                           jnp.asarray(aabb))["diffuse_image"])(jt.state["ema"])
        with torch.no_grad():
            ours = render_scene(tr.ema_net, SceneRenderOptions(**kw), torch.from_numpy(bits),
                                torch.from_numpy(o), torch.from_numpy(d), 1.0,
                                torch.from_numpy(aabb))["diffuse_image"].numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=RENDER_ATOL)
    assert {id(p) for p in tr.net.diffuse_env_net.parameters()} <= \
        {id(p) for p in tr.optimizer.params}
