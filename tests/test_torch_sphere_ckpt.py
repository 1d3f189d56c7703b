"""The tracked neural-renderer pretrains rendered by the port on the CPU
against the JAX package's render of the same view from the same checkpoint:

* ``assets/env_sphere_pretrain_best.ckpt`` (``neural_renderer_cp.ini``:
  CP 16 x 32, 11 env nets) on the generated val view 0, with its material
  and env index, through the eval path (EMA parameters, no mirror image);
* ``assets/renv_pretrain_best.ckpt`` (``neural_renderer_renv.ini`` with the
  CP encoder it was trained with) on the tracked renv set's val view 0, with
  its mirror-sphere image (the specular colour is then ``renv_net``'s) and
  without it (the env branch's: the eval path, which cannot see
  ``renv_net``).

Both at 50x50, pixel for pixel and by PSNR.  The readings behind the
tolerances: ``python tests/sphere_readings.py``."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.geometry.rays import full_image_rays as jax_full_image_rays
from envidr_tpu.geometry.rays import srgb_to_linear as jax_srgb_to_linear
from envidr_tpu.render.sphere import SphereRenderOptions as JaxSphereOptions
from envidr_tpu.render.sphere import render_sphere as jax_render_sphere
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.env_dataset import EnvSphereDataset, generate_env_sphere
from envidr_tpu_torch.train.metrics import psnr
from envidr_tpu_torch.train.trainer import Trainer, eval_pair
from test_torch_helpers import ROOT, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()
PRETRAIN_CKPT = os.path.join(ROOT, "assets", "env_sphere_pretrain_best.ckpt")
RENV_CKPT = os.path.join(ROOT, "assets", "renv_pretrain_best.ckpt")
SPHERE_INI = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
RENV_INI = os.path.join(ROOT, "configs", "neural_renderer_renv.ini")
RENV_DATA = os.path.join(ROOT, "data", "env_sphere_renv")
# the renv pretrain as it was trained (tools/r3_campaign.sh:61-62)
RENV_CP = dict(encoding_pos="cp", cp_rank=32, color_mlp_path="")
SIZE = 50
# per pixel, port against the jitted JAX render, both with the bf16 CP
# encoder, whose normals JAX's jit computes with fewer bf16 roundings (trap
# C3).  Readings (tests/sphere_readings.py): pretrain max 9.5e-4, renv with
# mirror images 1.1e-4, without 9.5e-4; 2.5e-3 leaves 2.6x room; PSNRs
# within 1e-4 dB
PIXEL_ATOL = 2.5e-3
PSNR_ATOL_DB = 0.05


def downscaled_renv_val(size=SIZE):
    """The tracked renv set's val view 0 (and its mirror image) downscaled
    by striding, with the intrinsics scaled to match."""
    val = EnvSphereDataset(RENV_DATA, "val", scale=0.8, with_renv=True)
    s = val.H // size
    val.images, val.r_images = val.images[:1, ::s, ::s], val.r_images[:1, ::s, ::s]
    val.poses = val.poses[:1]
    val.H = val.W = size
    f = val.intrinsics[0] / s
    val.intrinsics = (f, f, size / 2, size / 2)
    return val


def port_trainer(config, ckpt, **extra):
    opt = load_options(config, eval_ray_chunk=SIZE * SIZE, **extra)
    tr = Trainer(opt, network_config(opt), device="cpu")
    assert tr.load_checkpoint(ckpt)
    return tr


def jax_sphere_view(config, ckpt, val, workspace, with_r_image=False, **extra):
    """The JAX package's render of view 0 of ``val``: through its eval path
    (``render_image``, no mirror image), or with ``with_r_image`` through
    ``render_sphere`` with the view's mirror image, linearised as its train
    step linearises it.  Linear radiance [H, W, 3]."""
    jopt = jax_load(config, workspace=workspace, eval_ray_chunk=SIZE * SIZE, **extra)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=workspace)
    assert jt.load_checkpoint(ckpt)
    m = val.material(0)
    material = {"roughness": m["roughness"], "metallic": m["metallic"],
                "color": jnp.asarray(m["color"])}
    env = int(val.env_index[0])
    if not with_r_image:
        return jt.render_image(val.poses[0], val.intrinsics, val.H, val.W, mode="sphere",
                               material=material, env_index=env)["image"]
    o, d = jax_full_image_rays(jnp.asarray(val.poses[:1]), val.intrinsics, val.H, val.W)
    r = jnp.asarray(val.r_images[0].reshape(-1, 3).astype(np.float32) / 255.0)
    out = jax_render_sphere(jt.state["ema"], jt.cfg, JaxSphereOptions(radius=jopt.env_sph_radius),
                            o[0], d[0], 1.0, material=material, env_index=env,
                            r_images=jax_srgb_to_linear(r))
    return np.asarray(out["image"]).reshape(val.H, val.W, 3)


@pytest.fixture(scope="module")
def pretrain_view(tmp_path_factory):
    val = generate_env_sphere("val", 1, size=SIZE, device="cpu")
    tr = port_trainer(SPHERE_INI, PRETRAIN_CKPT)
    res = tr.render_view(val, 0)
    ref = jax_sphere_view(SPHERE_INI, PRETRAIN_CKPT, val, str(tmp_path_factory.mktemp("jax")))
    return tr, val, res, ref


def test_pretrain_checkpoint_loads_the_env_net_stack(pretrain_view):
    tr = pretrain_view[0]
    assert tr.epoch == 60 and tr.net.env_nets[0].weight.shape == (11, 160, 38)
    assert tr.cfg.cp_spec.rank == 32 and tr.net.sdf_net[0].weight.shape == (64, 37)


def test_pretrain_view_matches_the_jax_render(pretrain_view):
    tr, val, res, ref = pretrain_view
    img = res["image"]
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
    err = np.abs(img - ref)
    assert err.max() <= PIXEL_ATOL, (err.max(), err.mean())
    p = psnr(*eval_pair(res, val, 0, tr.opt))
    pj = psnr(*eval_pair({"image": ref}, val, 0, tr.opt))
    assert p == pytest.approx(pj, abs=PSNR_ATOL_DB) and p > 20.0, (p, pj)


@pytest.fixture(scope="module")
def renv_views(tmp_path_factory):
    val = downscaled_renv_val()
    tr = port_trainer(RENV_INI, RENV_CKPT, **RENV_CP)
    ws = str(tmp_path_factory.mktemp("jax"))
    out = {}
    for with_r in (True, False):
        out[("port", with_r)] = tr.render_view(val, 0, with_r_image=with_r)["image"]
        out[("jax", with_r)] = jax_sphere_view(RENV_INI, RENV_CKPT, val, ws, with_r, **RENV_CP)
    return tr, val, out


@pytest.mark.parametrize("with_r", [True, False], ids=["with_r_image", "without"])
def test_renv_view_matches_the_jax_render(renv_views, with_r):
    tr, val, out = renv_views
    err = np.abs(out[("port", with_r)] - out[("jax", with_r)])
    assert err.max() <= PIXEL_ATOL, (err.max(), err.mean())
    p = psnr(*eval_pair({"image": out[("port", with_r)]}, val, 0, tr.opt))
    pj = psnr(*eval_pair({"image": out[("jax", with_r)]}, val, 0, tr.opt))
    assert p == pytest.approx(pj, abs=PSNR_ATOL_DB), (p, pj)


def test_mirror_images_change_the_renv_render(renv_views):
    """Without mirror images the specular colour of a train_renv model comes
    from the env nets, so the eval path (and the PSNR it records) cannot see
    renv_net; with them it does, in both packages."""
    tr, _, out = renv_views
    assert tr.cfg.train_renv and tr.opt.train_renv
    for pkg in ("port", "jax"):
        assert np.abs(out[(pkg, True)] - out[(pkg, False)]).max() > 1e-2, pkg


def test_renv_checkpoint_holds_the_pretrain_frozen():
    """The renv pretrain trained renv_net alone: every other module of
    renv_pretrain_best.ckpt's parameters equals the pretrain's EMA, which it
    resumed whole (its EMA of those modules drifts by f32 rounding:
    0.95 e + 0.05 p is not always p)."""
    import jax
    from envidr_tpu_torch.train.trainer import read_checkpoint
    a = read_checkpoint(PRETRAIN_CKPT)["ema"]
    b = read_checkpoint(RENV_CKPT)["params"]
    assert set(b) - set(a) == {"renv_net"}
    for name in a:
        for x, y in zip(jax.tree.leaves(a[name]), jax.tree.leaves(b[name])):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_evaluate_in_sphere_mode_matches_jax(pretrain_view, tmp_path):
    """``evaluate`` of the pretrain on the generated view with the unwrap
    material forced (``overwrite_materials``) and another env net
    (``set_env_net_index``), as the JAX trainer's evaluate reads it."""
    import dataclasses
    tr, val, _, _ = pretrain_view
    kw = dict(overwrite_materials=True, set_env_net_index=3)
    tr.opt = dataclasses.replace(tr.opt, **kw)
    try:
        p = tr.evaluate(val, track_best=False)
    finally:
        tr.opt = dataclasses.replace(tr.opt, overwrite_materials=False, set_env_net_index=-1)
    jopt = jax_load(SPHERE_INI, workspace=str(tmp_path), eval_ray_chunk=SIZE * SIZE, **kw)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
    assert jt.load_checkpoint(PRETRAIN_CKPT)

    class Split:                     # the JAX evaluate's view of the split
        images, poses, intrinsics, H, W = val.images, val.poses, val.intrinsics, val.H, val.W
        materials = [val.material(0)]
        env_indices = val.env_index

        def __len__(self):
            return 1

    pj = jt.evaluate(Split(), mode="sphere", max_images=1, track_best=False)
    assert p == pytest.approx(pj, abs=PSNR_ATOL_DB), (p, pj)
    assert tr.stats["results"][-1]["psnr"] == p
