"""The repo's trained Laplace checkpoint (``assets/r4_laplace_cue_best.ckpt``,
the JAX package's ``r4_laplace_cue.ini`` run: CP encoder, Laplace density,
geometric cue and ``beta_cap_sched``) loaded by the port and rendered on the
CPU: the PSNR of val view 0 at downscale 4 against the bar that the JAX
package's own render of that view sets (tests/ours_readings.py), and a few
hundred of its pixels against the JAX render of the same rays."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.geometry.rays import full_image_rays
from envidr_tpu_torch.train.metrics import psnr
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import ROOT, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()
CKPT = os.path.join(ROOT, "assets", "r4_laplace_cue_best.ckpt")
CUE_INI = os.path.join(ROOT, "configs", "r4_laplace_cue.ini")
# small chunks, as tests/test_torch_cp_ckpt.py renders on the CPU
SMALL_EVAL = dict(eval_ray_chunk=512, eval_samples_budget=128)
# the JAX package's render of this view on the CPU reads 24.6847 dB
# (tests/ours_readings.py), the port's 24.6849; the bar is the JAX reading
# less 0.5 dB
JAX_PSNR_DB = 24.6847
PSNR_MIN_DB = JAX_PSNR_DB - 0.5
# per pixel, port against the jitted JAX eval, both with the bf16 CP encoder
# (tests/test_torch_cp_ckpt.py's bound).  Readings over these 256 pixels
# (tests/ours_readings.py): max 8.4e-4, mean 1.6e-5, 99th percentile 1.9e-4;
# 2e-3 leaves 2x room
PIXEL_ATOL = 2e-3
N_FG, N_BG = 192, 64


@pytest.fixture(scope="module")
def port_view():
    return render_port_view()


def render_port_view():
    """(trainer, val split at downscale 4, render of view 0) on the CPU."""
    opt = load_options(CUE_INI, **SMALL_EVAL)
    tr = Trainer(opt, network_config(opt), device="cpu")
    assert tr.load_checkpoint(CKPT)
    val = SynthSpheres("val", scale=opt.scale, downscale=4)
    res = tr.render_image(val.poses[0], val.intrinsics, val.H, val.W, use_ema=False)
    return tr, val, res


def view_psnr(val, image) -> float:
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])        # white bg, as trained
    return psnr(image, gt)


def test_laplace_checkpoint_loads(port_view):
    tr = port_view[0]
    assert (tr.epoch, tr.global_step) == (470, 23500)
    assert not tr.cfg.use_neus_sdf and tr.cfg.use_sdf
    assert float(tr.net.sdf_density.beta.detach()) == pytest.approx(0.0019265005830675364,
                                                                    rel=0, abs=0)


def test_val_view_psnr(port_view):
    _, val, res = port_view
    img = res["image"]
    assert img.shape == (val.H, val.W, 3) == (100, 100, 3) and np.isfinite(img).all()
    p = view_psnr(val, img)
    assert p > PSNR_MIN_DB, f"checkpoint render PSNR {p:.4f} dB"


def test_pixels_match_the_jax_render(port_view, tmp_path):
    err, ref = pixel_errors(port_view, str(tmp_path))
    assert err.max() <= PIXEL_ATOL, (f"max {err.max()}, mean {err.mean()}, "
                                     f"99th pct {np.percentile(err, 99)}")
    assert ref[:N_FG].std() > 0.05                      # real foreground colours


def jax_trainer(workspace: str):
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.train.trainer import Trainer as JaxTrainer

    opt = jax_load(CUE_INI, workspace=workspace, **SMALL_EVAL)
    jt = JaxTrainer(opt, jax_netcfg(opt), workspace=workspace)
    assert jt.load_checkpoint(CKPT)
    return jt


def pixel_errors(port_view, workspace: str):
    """|port - JAX| of N_FG foreground and N_BG background pixels of the
    view, and the JAX pixels; the JAX trainer renders those rays alone."""
    _, val, res = port_view
    jt = jax_trainer(workspace)
    alpha = val.images[0][..., 3].reshape(-1)
    rng = np.random.default_rng(0)
    pick = np.concatenate([rng.choice(np.flatnonzero(alpha > 0), N_FG, replace=False),
                           rng.choice(np.flatnonzero(alpha == 0), N_BG, replace=False)])
    rays_o, rays_d = full_image_rays(torch.from_numpy(val.poses[:1]), val.intrinsics,
                                     val.H, val.W)
    o = rays_o[0].numpy()[pick].reshape(2, -1, 3)         # two chunks of the JAX eval
    d = rays_d[0].numpy()[pick].reshape(2, -1, 3)
    eval_fn = jt._eval_fn("scene", jt._eval_samples_budget("scene"))
    out = eval_fn(jt.state["params"], jt.state["grid"].bitfield, jnp.asarray(o),
                  jnp.asarray(d), jnp.asarray(1.0, jnp.float32),
                  jnp.asarray([-1.0] * 3 + [1.0] * 3), None, 0, None)
    ref = np.asarray(out["image"]).reshape(-1, 3)
    return np.abs(res["image"].reshape(-1, 3)[pick] - ref), ref
