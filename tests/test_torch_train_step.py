"""One train step of the port (train/trainer.py) against the JAX package:
the same loss terms and gradients from shared parameters and rays, the same
optimizer update, and the same in-memory scene as tools/gen_synth_scene.py."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from envidr_tpu.data.nerf_dataset import NeRFDataset
from envidr_tpu.render.scene import SceneRenderOptions, render_scene
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from envidr_tpu_torch.data.synth_scene import SynthSpheres, render as torch_render
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import ROOT, camera_rays, export_jax_layout, rel_err, shared_model

TERM_RTOL = 1e-4     # f32 loss terms over 64 rays x 32 samples
GRAD_RTOL = 1.3e-3   # f32 double backward, rel. to max (ROADMAP C-3)
K = 32


def _gen_synth_scene():
    path = os.path.join(ROOT, "tools", "gen_synth_scene.py")
    spec = importlib.util.spec_from_file_location("gen_synth_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(n=64, seed=0):
    o, d = camera_rays(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pix = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=n) > 0.4).astype(np.float32)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    bits = np.random.default_rng(seed + 2).uniform(size=(1, 128 ** 3)) < 0.6
    return o, d, gt.astype(np.float32), bg, pix[:, 3].copy(), bits


@pytest.fixture(scope="module")
def step_case():
    (jopt, jcfg, params), (topt, tcfg, net) = shared_model(seed=7)
    o, d, gt, bg, alpha, bits = _batch()
    jsched = jax_resolve(jopt, 1, 0)
    ropts = SceneRenderOptions(max_steps=jsched.max_steps, num_samples=K,
                               early_stop_steps=jsched.early_stop_steps,
                               dt_gamma=jopt.dt_gamma, T_thresh=jopt.T_thresh,
                               min_near=jopt.min_near, training=True)
    aabb = jnp.asarray([-1.0] * 3 + [1.0] * 3)

    def loss_fn(p):
        out = render_scene(p, jcfg, ropts, jnp.asarray(bits), jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(bg), aabb)
        return compute_losses(out, jnp.asarray(gt), jsched.flags,
                              {k: jnp.asarray(v) for k, v in jsched.weights.items()},
                              alpha_mask=jnp.asarray(alpha))

    jp = jax.tree.map(jnp.asarray, params)
    (jl, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)

    tr = Trainer(topt, tcfg, device="cpu", net=net)
    tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
    tl, out, tterms = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, alpha)),
                                      K=K, sched=resolve(topt, 1, 0))
    tl.backward()
    return dict(jopt=jopt, params=params, jl=float(jl), jterms=jterms,
                jgrads=jax.tree.map(np.asarray, jgrads), tr=tr, tl=float(tl.detach()),
                tterms=tterms, out=out)


def test_loss_terms_match(step_case):
    c = step_case
    assert set(c["tterms"]) == set(c["jterms"]) == {"color", "mask", "eikonal"}
    for k, v in c["jterms"].items():
        assert float(c["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert c["tl"] == pytest.approx(c["jl"], rel=TERM_RTOL)
    assert int(c["out"]["counts"].sum()) > 0


@pytest.mark.parametrize("leaf", ["encoder", "sdf_density", "sdf_net", "diffuse_net",
                                  "color_net", "env_net"])
def test_gradients_match(step_case, leaf):
    ours = export_jax_layout(step_case["tr"].net, grads=True)[leaf]
    ref = step_case["jgrads"][leaf]
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    ours_leaves = dict(jax.tree_util.tree_leaves_with_path(ours))
    for path, a in ref_leaves:
        if np.abs(a).max() == 0:
            assert np.abs(ours_leaves[path]).max() == 0, path
        else:
            assert rel_err(a, ours_leaves[path]) < GRAD_RTOL, (leaf, path)


def _torch_layout_grads(net, jgrads):
    with torch.no_grad():
        net.encoder.embeddings.grad = torch.tensor(jgrads["encoder"]["embeddings"])
        net.sdf_density.beta.grad = torch.tensor(jgrads["sdf_density"]["beta"])
        for name in ("sdf_net", "diffuse_net", "color_net", "env_net"):
            for layer, g in zip(getattr(net, name), jgrads[name]):
                layer.weight.grad = torch.tensor(g["w"].T.copy())
                layer.bias.grad = torch.tensor(g["b"])


@pytest.mark.parametrize("grad_scale", [1.0, 1e3])
def test_optimizer_update_matches_optax(grad_scale):
    """Adam groups, per-group clip at global norm 10 (triggered at x1e3) and the
    lr decay over two updates; then the EMA."""
    (jopt, _, params), (topt, tcfg, net) = shared_model(seed=8)
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * grad_scale
                                     ).astype(np.float32), params) for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, params)
    tx = jax_make_optimizer(jp, jopt)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    ema = [p.detach().clone() for p in tr.ema_net.parameters()]
    for g in grads:
        _torch_layout_grads(tr.net, g)
        tr._apply_update()
        ema = [0.95 * e + 0.05 * p.detach() for e, p in zip(ema, tr.net.parameters())]
    ours = export_jax_layout(tr.net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jp)), jax.tree_util.tree_leaves_with_path(ours)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=str(path))
    assert tr.applied_steps == 2 and tr.notfinite == 0
    for e, want in zip(tr.ema_net.parameters(), ema):      # per-step EMA 0.95
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-7)


def test_non_finite_update_is_skipped_and_counted():
    (_, _, params), (topt, tcfg, net) = shared_model(seed=10)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    before = [p.detach().clone() for p in tr.net.parameters()]
    g = jax.tree.map(lambda a: np.ones_like(a), params)
    g["color_net"][0]["w"][0, 0] = np.nan
    _torch_layout_grads(tr.net, g)
    tr._apply_update()
    assert tr.notfinite == 1 and tr.applied_steps == 0
    for a, b in zip(before, tr.net.parameters()):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in tr.net.parameters())


def test_train_steps_and_render_on_tiny_scene():
    (_, _, _), (topt, tcfg, net) = shared_model(seed=11)
    ds = SynthSpheres("train", size=24, n=3, scale=topt.scale)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    losses = [tr.train_step(ds)["loss"] for _ in range(3)]
    assert np.isfinite(losses).all() and tr.notfinite == 0
    assert tr.grid.iter_density == 1 and tr.global_step == 3
    assert tr.mean_count > 0
    res = tr.render_image(ds.poses[0], ds.intrinsics, ds.H, ds.W)
    assert res["image"].shape == (24, 24, 3) and np.isfinite(res["image"]).all()


def test_sample_budget_rule():
    (_, _, _), (topt, tcfg, net) = shared_model(seed=12)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    sched = resolve(topt, 1, 0)
    assert tr.sample_budget(sched) == 64              # empty history: the cap
    tr.mean_count = 10.0
    assert tr.sample_budget(sched) == 32              # floor min_samples_budget
    tr.mean_count = 30.0
    assert tr.sample_budget(sched) == 64
    assert tr.eval_samples_budget() == 64


def test_in_memory_scene_matches_generator(tmp_path):
    gen = _gen_synth_scene()
    c2w = gen.pose_spherical(0.7, -0.4)
    np.testing.assert_array_equal(torch_render(c2w, 40, 40, 50.0),
                                  gen.render(c2w, 40, 40, 50.0))
    size = 32
    gen.write_split(str(tmp_path), "val", 2, size, size * 1.25, 1)
    ref = NeRFDataset(str(tmp_path), "val", scale=0.8)
    ours = SynthSpheres("val", size=size, n=2, scale=0.8)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    assert ours.intrinsics == ref.intrinsics and (ours.H, ours.W, ours.C) == (ref.H, ref.W, ref.C)


def test_non_finite_update_leaves_every_state_bit_equal():
    """After one applied update (so the moments are not zero), a non-finite
    one leaves the parameters, both moments and both counters as they were."""
    (_, _, params), (topt, tcfg, net) = shared_model(seed=13)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    g = jax.tree.map(lambda a: np.full_like(a, 0.5), params)
    _torch_layout_grads(tr.net, g)
    tr._apply_update()
    adam = tr.optimizer
    state = [t.clone() for t in (*tr.net.parameters(), *adam.m, *adam.v,
                                 adam.count, adam.skipped)]
    assert int(adam.count) == 1 and any(bool(m.ne(0).any()) for m in adam.m)
    g["encoder"]["embeddings"][0, 0] = np.inf
    _torch_layout_grads(tr.net, g)
    tr._apply_update()
    after = [*tr.net.parameters(), *adam.m, *adam.v, adam.count]
    for a, b in zip(state, after):
        assert torch.equal(a, b)
    assert int(tr.notfinite) == 1 and int(tr.applied_steps) == 1


def test_device_mean_count_ema_and_next_epoch_budget_match_host_formula():
    """The EMA kept on the device equals the reference's host EMA in Python
    floats (trainer.py:662), and the next epoch chooses the K that the host
    value gives."""
    (_, _, _), (topt, tcfg, net) = shared_model(seed=14)
    ds = SynthSpheres("train", size=24, n=2, scale=topt.scale)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    host = -1.0
    for step in range(3):                    # the third step starts epoch 2
        mc = float(tr.train_step(ds)["mean_count"])
        if step == 2:
            assert tr.epoch == 2
            assert tr._K == Trainer.sample_budget(SimpleNamespace(opt=topt, mean_count=host),
                                                  tr._sched)
        host = mc if host < 0 else 0.9 * host + 0.1 * mc
        assert tr.mean_count.dtype == torch.float64 and float(tr.mean_count) == host


def test_train_step_returns_device_tensors():
    (_, _, _), (topt, tcfg, net) = shared_model(seed=15)
    ds = SynthSpheres("train", size=24, n=2, scale=topt.scale)
    tr = Trainer(topt, tcfg, device="cpu", net=net)
    m = tr.train_step(ds)
    assert set(m) == {"color", "mask", "eikonal", "loss", "mean_count", "notfinite", "K",
                      "index"}
    for k, v in m.items():
        if k == "K":
            assert isinstance(v, int) and v == tr._K
        elif k == "index":          # the frame the step drew
            assert isinstance(v, int) and 0 <= v < len(ds)
        else:
            assert isinstance(v, torch.Tensor) and not v.requires_grad, k
            assert v.device.type == "cpu" and v.dim() == 0, k
    assert tr.step_may_sync() is False       # second step: no epoch start, no refresh
