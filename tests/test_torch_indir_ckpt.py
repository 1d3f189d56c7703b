"""Checkpoints of the interreflection scenes in the port: resuming as the JAX
trainer resumes (the lr schedule re-timed when the file has no optimizer
state, the optax state restored when it has one), the restricted unpickler's
allow-list of optax stand-ins, a port checkpoint read by the JAX trainer,
and the trained shiny3 scene (``assets/shiny3_backsdf_ep40.ckpt``, the JAX
package's ``shiny3_indir.ini`` run at epoch 40) rendered through the
three-pass path on the CPU against the JAX package's own render.  The
readings behind the bars: tests/indir_readings.py."""

import io
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.render.scene import SceneRenderOptions as JaxRenderOptions
from envidr_tpu.render.scene import render_scene as jax_render
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
from envidr_tpu_torch.geometry.rays import full_image_rays
from envidr_tpu_torch.io.jax_params import module_arrays
from envidr_tpu_torch.train.metrics import psnr
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer, _ArrayUnpickler, eval_pair, read_checkpoint
from test_torch_helpers import (ROOT, camera_rays, export_jax_layout, f32_cp_encoder,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
SHINY3_CKPT = os.path.join(ROOT, "assets", "shiny3_backsdf_ep40.ckpt")
SHINY3_INI = os.path.join(ROOT, "configs", "scenes", "shiny3_indir.ini")
SHINY3_DATA = os.path.join(ROOT, "data", "synth_shiny3")
CP_CKPT = os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt")
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
# the checkpoint holds every net, so no pretrain is loaded before it
NO_PRETRAIN = dict(color_mlp_path="")
SMALL_EVAL = dict(eval_ray_chunk=512, eval_samples_budget=128)
# one resumed Adam update of each leaf, rel. to its max: Adam divides each
# entry by the root of its own second moment, so an entry with a small moment
# turns the gradients' f32 noise (GRAD_RTOL, 1.3e-3 of the max gradient) into
# a larger share of the max update.  Readings (tests/indir_readings.py):
# port against JAX 2.17e-3 (encoder), 1.24e-3 (env_net), 1.04e-3 (sdf_net);
# each f32 step against the port's f64 step 6.4e-2 (encoder); 5e-3 leaves 2x
UPDATE_RTOL = 5e-3
# the JAX package's render of val view 0 at downscale 4 through the three
# passes, on the CPU (tests/indir_readings.py); the bar is 0.5 dB below it
JAX_PSNR_DB = 18.5591
PSNR_MARGIN_DB = 0.5
# per pixel, port against the jitted JAX eval, both with the bf16 CP encoder,
# whose normals JAX's jit computes with fewer bf16 roundings (trap C3), and
# through three passes: the reflected rays start at pass 1's depth and turn
# about its normals.  Readings over the view's 256 pixels (tests/
# indir_readings.py): max 2.47e-3, mean 2.9e-5, 99th percentile 4.8e-4; 5e-3
# leaves 2x room
PIXEL_ATOL = 5e-3
N_FG, N_BG = 192, 64
K = 32


def test_resume_without_optimizer_state_retimes_the_lr_schedule(tmp_path):
    """assets/neus_cp_long_best.ckpt carries no opt_state: the first resumed
    update takes the decayed lr ``lr * 0.1 ** (global_step / iters)``, as
    the JAX trainer's re-timed optax state gives it, not the base lr.  With
    fresh moments the first Adam update of an entry is lr x decay x
    g / (|g| + 1e-15), so the largest |update| of a group is that lr."""
    jopt = jax_load(CP_INI, workspace=str(tmp_path))
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
    assert jt.load_checkpoint(CP_CKPT)
    jchain = jt.state["opt_state"].inner_state.inner_states["net"].inner_state
    assert (int(jchain[1].count), int(jchain[2].count)) == (0, 3000)
    opt = load_options(CP_INI, num_rays=64)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.load_checkpoint(CP_CKPT)
    decay = 0.1 ** min(3000 / opt.iters, 1.0)
    assert int(tr.optimizer.count) == 0 and int(tr.optimizer.sched_count) == 3000
    assert float(tr.optimizer.decay()) == pytest.approx(decay, rel=1e-6)
    before = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
    o, d = camera_rays(64, seed=1)
    gt = np.random.default_rng(1).uniform(size=(64, 3)).astype(np.float32)
    loss, _, _ = tr.forward_loss(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(gt),
                                 torch.ones(64, 3), None, K=K, sched=resolve(opt, 61, 3000))
    loss.backward()
    tr._apply_update()
    step = max(float((p.detach() - before[n]).abs().max())
               for n, p in tr.net.named_parameters() if n.startswith("sdf_net"))
    assert step == pytest.approx(opt.lr * decay, rel=1e-3)


@pytest.fixture(scope="module")
def resumed_step(tmp_path_factory):
    with f32_cp_encoder():
        return _resumed_step(str(tmp_path_factory.mktemp("shiny3")))


def _resumed_step(workspace):
    """Both trainers load the full checkpoint (optax state included); one
    update on the same 64 rays (epoch 41: the error map in use, the indirect
    pass not yet on), with the CP encoder in f32 and the JAX step jitted."""
    jopt = jax_load(SHINY3_INI, workspace=workspace, num_rays=64, **NO_PRETRAIN)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=workspace)
    assert jt.load_checkpoint(SHINY3_CKPT)
    opt = load_options(SHINY3_INI, num_rays=64, **NO_PRETRAIN)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.load_checkpoint(SHINY3_CKPT)

    o, d = camera_rays(64, seed=2)
    rng = np.random.default_rng(2)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    jsched = jax_resolve(jopt, 41, 2400)
    assert jsched.use_error_map and not jsched.indir_ref
    ropts = JaxRenderOptions(max_steps=jsched.max_steps, num_samples=K,
                             early_stop_steps=jsched.early_stop_steps, min_near=jopt.min_near,
                             training=True, cos_anneal_ratio=jsched.cos_anneal_ratio)
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}
    bits = jt.state["grid"].bitfield

    def loss_fn(p):
        out = jax_render(p, jt.cfg, ropts, bits, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(bg), jnp.asarray([-1.0] * 3 + [1.0] * 3))
        inv_s = jnp.clip(jnp.exp(p["sdf_density"]["variance"] * 10.0), 1e-6, 1e6)
        return compute_losses(out, jnp.asarray(gt), jsched.flags, weights, neus_inv_s=inv_s,
                              alpha_mask=jnp.asarray(pix[:, 3]))[0]

    @jax.jit
    def update(params, opt_state):
        grads = jax.grad(loss_fn)(params)
        upd, new_state = jt.optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), new_state

    jparams = jt.state["params"]
    jnew, jstate = update(jparams, jt.state["opt_state"])
    before = jax.tree.map(np.copy, export_jax_layout(tr.net))      # not views
    loss, _, _ = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, pix[:, 3])),
                                 K=K, sched=resolve(opt, 41, 2400))
    loss.backward()
    tr._apply_update()
    return dict(jt=jt, tr=tr, jold=jax.tree.map(np.asarray, jparams),
                jnew=jax.tree.map(np.asarray, jnew), jstate=jstate, before=before,
                after=export_jax_layout(tr.net))


def test_resume_with_optimizer_state_restores_moments_and_both_counts(resumed_step):
    tr = resumed_step["tr"]
    payload = read_checkpoint(SHINY3_CKPT)
    states = payload["opt_state"].inner_state.inner_states
    adam = states["net"].inner_state[1]
    assert (int(adam.count), int(states["net"].inner_state[2].count)) == (2400, 2400)
    assert tr.global_step == 2400 and tr.epoch == 40
    assert tr.error_map.shape == (60, 128 * 128) and len(tr.stats["results"]) == 3
    assert int(tr.notfinite) == int(payload["opt_state"].total_notfinite) == 0
    # one update later both counts stand one further, the moments restored
    assert int(tr.optimizer.count) == int(tr.optimizer.sched_count) == 2401
    fresh = Trainer(tr.opt, tr.cfg, device="cpu")
    fresh.load_checkpoint(SHINY3_CKPT)
    index = {id(p): i for i, p in enumerate(fresh.optimizer.params)}
    for name in ("sdf_net", "renv_net", "encoder"):
        module = getattr(fresh.net, name)
        label = {"encoder": "grid"}.get(name, "net")
        mu = states[label].inner_state[1].mu[name]
        for p, want in zip(module.parameters(), module_arrays(module, mu)):
            np.testing.assert_array_equal(fresh.optimizer.m[index[id(p)]].numpy(), want)
    frozen = {id(p) for n in ("color_net", "diffuse_net")
              for p in getattr(fresh.net, n).parameters()}
    assert not frozen & set(index)                 # the frozen nets hold no moments


@pytest.mark.parametrize("leaf", ["encoder", "sdf_density", "sdf_net", "env_net", "renv_net"])
def test_resumed_update_matches_jax(resumed_step, leaf):
    """One update after both packages resumed the same file, on the same rays:
    the change of each trainable leaf within UPDATE_RTOL of JAX's (frozen nets
    unchanged in both)."""
    c = resumed_step
    errs = {}
    for path, old in jax.tree_util.tree_leaves_with_path(c["jold"][leaf]):
        new = dict(jax.tree_util.tree_leaves_with_path(c["jnew"][leaf]))[path]
        mine_old = dict(jax.tree_util.tree_leaves_with_path(c["before"][leaf]))[path]
        mine_new = dict(jax.tree_util.tree_leaves_with_path(c["after"][leaf]))[path]
        np.testing.assert_array_equal(mine_old, old)
        errs[jax.tree_util.keystr(path)] = rel_err(new - old, mine_new - mine_old)
    assert max(errs.values()) <= UPDATE_RTOL, errs
    for name in ("color_net", "diffuse_net"):
        for a, b in zip(jax.tree.leaves(c["jold"][name]), jax.tree.leaves(c["after"][name])):
            np.testing.assert_array_equal(a, b)


def test_unpickler_reads_optax_stand_ins_and_refuses_any_other_global():
    payload = read_checkpoint(SHINY3_CKPT)
    fin = payload["opt_state"]
    assert type(fin).__name__ == "ApplyIfFiniteState" and set(fin.inner_state.inner_states) == {
        "env", "frozen", "grid", "net", "scalar"}
    assert type(fin.inner_state.inner_states["env"].inner_state[1].mu["encoder"]["proj"][0]
                ).__name__ == "MaskedNode"
    evil = pickle.dumps({"x": os.system}, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|nt.system"):
        _ArrayUnpickler(io.BytesIO(evil)).load()
    for module, name in (("optax._src.base", "GradientTransformation"),
                         ("optax._src.transform", "ScaleByRmsState"), ("builtins", "eval")):
        with pytest.raises(pickle.UnpicklingError, match="not a part of a numpy array"):
            _ArrayUnpickler(io.BytesIO(b"")).find_class(module, name)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A small shiny3 trainer after two steps on the tracked scene (downscale
    8, two views), saved by the port, and the JAX trainer that loaded it."""
    ws = str(tmp_path_factory.mktemp("port_ckpt"))
    small = dict(num_levels=4, desired_resolution=64, cp_rank=8, hidden_dim=16,
                 hidden_dim_color=16, hidden_dim_env=16, num_rays=64, **NO_PRETRAIN, **SMALL_EVAL)
    opt = load_options(SHINY3_INI, workspace=ws, **small)
    tr = Trainer(opt, network_config(opt), device="cpu")
    data = NeRFDataset(SHINY3_DATA, "train", scale=opt.scale, downscale=8)
    data.images, data.poses = data.images[:2], data.poses[:2]
    tr.epoch = 75                     # the indirect pass and grad rays on
    for _ in range(2):
        tr.train_step(data)
    path = tr.save_checkpoint()
    jopt = jax_load(SHINY3_INI, workspace=ws, **small)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=ws)
    assert jt.load_checkpoint(path)
    return tr, jt, path, data


def test_port_checkpoint_round_trips_and_loads_in_jax(saved):
    tr, jt, path, _ = saved
    assert os.path.basename(path) == "ep0076.ckpt"
    again = Trainer(tr.opt, tr.cfg, device="cpu")
    again.load_checkpoint(path)
    for a, b in zip([*tr.net.parameters(), *tr.ema_net.parameters(), *tr.optimizer.m,
                     *tr.optimizer.v, tr.error_map, tr.grid.density],
                    [*again.net.parameters(), *again.ema_net.parameters(), *again.optimizer.m,
                     *again.optimizer.v, again.error_map, again.grid.density]):
        assert torch.equal(a, b)
    for k in ("count", "sched_count", "skipped"):
        assert int(getattr(again.optimizer, k)) == int(getattr(tr.optimizer, k))
    assert int(again.optimizer.count) == 2 and again.global_step == 2
    for which, net in (("params", tr.net), ("ema", tr.ema_net)):
        ours = export_jax_layout(net)
        for path_, a in jax.tree_util.tree_leaves_with_path(jt.state[which]):
            np.testing.assert_array_equal(np.asarray(a),
                                          dict(jax.tree_util.tree_leaves_with_path(ours))[path_])
    np.testing.assert_array_equal(np.asarray(jt.state["error_map"]), tr.error_map.numpy())
    assert (jt.epoch, jt.global_step) == (76, 2)
    # JAX found no opt_state it knows and re-timed its schedule to the step
    sched = jt.state["opt_state"].inner_state.inner_states["net"].inner_state[2]
    assert int(sched.count) == 2


def test_port_checkpoint_renders_the_same_pixels_in_jax(saved):
    tr, jt, _, data = saved
    rays_o, rays_d = full_image_rays(torch.from_numpy(data.poses[:1]), data.intrinsics,
                                     data.H, data.W)
    pick = np.random.default_rng(3).choice(data.H * data.W, 128, replace=False)
    o, d = rays_o[0].numpy()[pick], rays_d[0].numpy()[pick]
    eval_fn = jt._eval_fn("scene", jt._eval_samples_budget("scene"))
    out = eval_fn(jt.state["ema"], jt.state["grid"].bitfield, jnp.asarray(o.reshape(2, -1, 3)),
                  jnp.asarray(d.reshape(2, -1, 3)), jnp.asarray(1.0, jnp.float32),
                  jnp.asarray([-1.0] * 3 + [1.0] * 3), None, 0, None)
    ref = np.asarray(out["image"]).reshape(-1, 3)
    assert tr.eval_samples_budget() == jt._eval_samples_budget("scene")
    res = tr.render_image(data.poses[0], data.intrinsics, data.H, data.W)
    err = np.abs(res["image"].reshape(-1, 3)[pick] - ref)
    assert err.max() <= PIXEL_ATOL, (err.max(), err.mean())


@pytest.fixture(scope="module")
def shiny3_view():
    """The trained scene's val view 0 at downscale 4, rendered by the port
    through the three passes (EMA parameters, as the JAX evaluate renders)."""
    opt = load_options(SHINY3_INI, **NO_PRETRAIN, **SMALL_EVAL)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.load_checkpoint(SHINY3_CKPT)
    val = NeRFDataset(SHINY3_DATA, "val", scale=opt.scale, downscale=4)
    res = tr.render_view(val, 0)
    return tr, val, res


def test_shiny3_view_psnr_against_the_jax_render(shiny3_view):
    tr, val, res = shiny3_view
    img = res["image"]
    assert img.shape == (100, 100, 3) and np.isfinite(img).all()
    p = psnr(*eval_pair(res, val, 0, tr.opt))
    assert abs(p - JAX_PSNR_DB) <= PSNR_MARGIN_DB, f"port {p:.4f} dB, JAX {JAX_PSNR_DB} dB"
    assert 0.0 < float(res["renv_mask_image"].mean()) < 1.0    # the renv branch is live


def shiny3_pixel_errors(shiny3_view, workspace: str):
    """|port - JAX| of N_FG foreground and N_BG background pixels of the view
    (linear radiance, before the sRGB conversion), and the JAX pixels."""
    _, val, res = shiny3_view
    jopt = jax_load(SHINY3_INI, workspace=workspace, **NO_PRETRAIN, **SMALL_EVAL)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=workspace)
    assert jt.load_checkpoint(SHINY3_CKPT)
    alpha = val.images[0][..., 3].reshape(-1)
    rng = np.random.default_rng(0)
    pick = np.concatenate([rng.choice(np.flatnonzero(alpha > 0), N_FG, replace=False),
                           rng.choice(np.flatnonzero(alpha == 0), N_BG, replace=False)])
    rays_o, rays_d = full_image_rays(torch.from_numpy(val.poses[:1]), val.intrinsics,
                                     val.H, val.W)
    o = rays_o[0].numpy()[pick].reshape(2, -1, 3)
    d = rays_d[0].numpy()[pick].reshape(2, -1, 3)
    eval_fn = jt._eval_fn("scene", jt._eval_samples_budget("scene"))
    out = eval_fn(jt.state["ema"], jt.state["grid"].bitfield, jnp.asarray(o), jnp.asarray(d),
                  jnp.asarray(1.0, jnp.float32), jnp.asarray([-1.0] * 3 + [1.0] * 3),
                  None, 0, None)
    ref = np.asarray(out["image"]).reshape(-1, 3)
    return np.abs(res["image"].reshape(-1, 3)[pick] - ref), ref


def test_shiny3_pixels_match_the_jax_render(shiny3_view, tmp_path):
    err, ref = shiny3_pixel_errors(shiny3_view, str(tmp_path))
    assert err.max() <= PIXEL_ATOL, (f"max {err.max()}, mean {err.mean()}, "
                                     f"99th pct {np.percentile(err, 99)}")
    assert ref[:N_FG].std() > 0.05


def test_ssim_matches_jax():
    from envidr_tpu.train.metrics import SSIMMeter as JaxSSIM
    from envidr_tpu_torch.train.metrics import SSIMMeter
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(37, 29, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    ours, ref = SSIMMeter(), JaxSSIM()
    assert ours.update(a, b) == ref.update(a, b) and 0.0 < ours.measure() < 1.0
    assert ours.update(a, a) == pytest.approx(1.0)


def test_evaluate_reports_psnr_and_ssim_and_keeps_the_best(saved):
    tr, _, _, data = saved
    p = tr.evaluate(data, max_images=2)
    res = tr.stats["results"][-1]
    views = [eval_pair(tr.render_view(data, i), data, i, tr.opt) for i in range(2)]
    assert p == pytest.approx(np.mean([psnr(*v) for v in views]))
    assert res["psnr"] == p and 0.0 < res["ssim"] < 1.0 and res["epoch"] == tr.epoch
    assert tr.stats["best_result"] == p
    assert os.path.exists(os.path.join(tr.workspace, "checkpoints", "best.ckpt"))
    assert "torch_optimizer" not in read_checkpoint(
        os.path.join(tr.workspace, "checkpoints", "best.ckpt"))


def test_save_checkpoint_rotates_epoch_checkpoints_and_keeps_best(tmp_path):
    """``max_keep_ckpt`` epoch checkpoints are kept, the oldest removed;
    ``best`` is never rotated (trainer.py:1037-1044)."""
    opt = load_options(SHINY3_INI, workspace=str(tmp_path), max_keep_ckpt=2, num_levels=4,
                       desired_resolution=64, cp_rank=8, hidden_dim=16, hidden_dim_color=16,
                       hidden_dim_env=16, **NO_PRETRAIN)
    tr = Trainer(opt, network_config(opt), device="cpu")
    paths = []
    for epoch in (1, 2, 3):
        tr.epoch = epoch
        paths.append(tr.save_checkpoint())
    best = tr.save_checkpoint(name="best", full=False)
    assert [os.path.exists(p) for p in paths] == [False, True, True]
    assert tr.stats["ckpts"] == paths[1:] and os.path.exists(best)
    assert os.path.basename(paths[0]) == "ep0001.ckpt"


def test_resumed_run_rotates_only_its_own_checkpoints(tmp_path, monkeypatch):
    """The shiny3 checkpoint's ``stats["ckpts"]`` names the epoch files of
    the run that wrote it, relative to that run's directory.  Saves after
    the resume rotate the files of their own workspace and leave those
    alone."""
    ws = tmp_path / "ws"
    monkeypatch.chdir(tmp_path)
    inherited = read_checkpoint(SHINY3_CKPT)["stats"]["ckpts"]
    assert len(inherited) == 2
    for p in inherited:                               # the JAX run's files, where it left them
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "wb").close()
    opt = load_options(SHINY3_INI, workspace=str(ws), **NO_PRETRAIN)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.load_checkpoint(SHINY3_CKPT)
    assert tr.stats["ckpts"] == inherited and opt.max_keep_ckpt == 2
    paths = []
    for epoch in (41, 42, 43):
        tr.epoch = epoch
        paths.append(tr.save_checkpoint(full=False))
    assert all(os.path.exists(p) for p in inherited)
    assert [os.path.exists(p) for p in paths] == [False, True, True]
    assert tr.stats["ckpts"] == paths[1:]
    assert sorted(os.listdir(ws / "checkpoints")) == ["ep0042.ckpt", "ep0043.ckpt"]
