"""The repo's trained CP checkpoint (``assets/neus_cp_long_best.ckpt``, the
JAX package's ``synth_spheres_cp.ini`` run) loaded by the port and rendered
on the CPU: the restricted unpickler, the PSNR of val view 0 at downscale 4
(the bar of tests/test_cp_quality_ckpt.py), and a few hundred of its pixels
against the JAX package's render of the same rays from the same checkpoint."""

import datetime
import io
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.synth_scene import SynthSpheres
from envidr_tpu_torch.geometry.rays import full_image_rays
from envidr_tpu_torch.train.metrics import psnr
from envidr_tpu_torch.train.trainer import Trainer, _ArrayUnpickler
from test_torch_helpers import ROOT

CKPT = os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt")
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
# small chunks, as tests/test_cp_quality_ckpt.py renders on the CPU
SMALL_EVAL = dict(eval_ray_chunk=512, eval_samples_budget=128)
PSNR_MIN_DB = 22.0   # reading: 25.82 dB (tests/cp_readings.py)
# per pixel, port against the jitted JAX eval: both run the bf16 CP encoder,
# whose normals (which the colour MLPs read) JAX's jit computes with fewer
# bf16 roundings (tests/test_torch_neus.py).  Reading over these 256 pixels
# (tests/cp_readings.py):
# max 3.6e-4, mean 9.1e-6, 99th percentile 1.3e-4; 2e-3 leaves 5x room
PIXEL_ATOL = 2e-3
N_FG, N_BG = 192, 64


@pytest.fixture(scope="module")
def port_view():
    return render_port_view()


def render_port_view():
    """(trainer, val split at downscale 4, render of view 0) on the CPU."""
    opt = load_options(CP_INI, **SMALL_EVAL)
    tr = Trainer(opt, network_config(opt), device="cpu")
    assert tr.load_checkpoint(CKPT)
    val = SynthSpheres("val", scale=opt.scale, downscale=4)
    res = tr.render_image(val.poses[0], val.intrinsics, val.H, val.W, use_ema=False)
    return tr, val, res


def test_checkpoint_loads_every_leaf(port_view):
    tr = port_view[0]
    assert (tr.epoch, tr.global_step) == (60, 3000)
    assert float(tr.mean_count) == pytest.approx(4.2093351266112915, rel=0, abs=0)
    occ = float(tr.grid.bitfield.float().mean())
    assert 0.0 < occ < 0.5 and tr.grid.iter_density > 0
    with open(CKPT, "rb") as f:
        payload = pickle.load(f)
    np.testing.assert_array_equal(tr.net.encoder.axes[15][2].detach().numpy(),
                                  payload["params"]["encoder"]["axes"][15][2])
    np.testing.assert_array_equal(tr.ema_net.env_net[0].weight.detach().numpy(),
                                  payload["ema"]["env_net"][0]["w"].T)
    assert float(tr.net.sdf_density.variance.detach()) == float(
        payload["params"]["sdf_density"]["variance"])


def test_unpickler_refuses_other_globals():
    for obj in ({"epoch": datetime.date(2020, 1, 1)}, {"f": os.getcwd}):
        with pytest.raises(pickle.UnpicklingError, match="not a part of a numpy array"):
            _ArrayUnpickler(io.BytesIO(pickle.dumps(obj))).load()
    arrays = {"a": np.arange(4, dtype=np.float32), "b": np.float32(2.5), "c": (np.ones(2, bool),)}
    got = _ArrayUnpickler(io.BytesIO(pickle.dumps(arrays))).load()
    np.testing.assert_array_equal(got["a"], arrays["a"])
    # numpy 1 names the array parts under numpy.core
    u = _ArrayUnpickler(io.BytesIO(b""))
    assert u.find_class("numpy.core.multiarray", "_reconstruct") is u.find_class(
        "numpy._core.multiarray", "_reconstruct")


def test_val_view_psnr(port_view):
    _, val, res = port_view
    img = res["image"]
    assert img.shape == (val.H, val.W, 3) == (100, 100, 3) and np.isfinite(img).all()
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])        # white bg, as trained
    p = psnr(img, gt)
    assert p > PSNR_MIN_DB, f"checkpoint render PSNR {p:.2f} dB"


def test_pixels_match_the_jax_render(port_view, tmp_path):
    err, ref = pixel_errors(port_view, str(tmp_path))
    assert err.max() <= PIXEL_ATOL, (f"max {err.max()}, mean {err.mean()}, "
                                     f"99th pct {np.percentile(err, 99)}")
    assert ref[:N_FG].std() > 0.05                      # real foreground colours


def pixel_errors(port_view, workspace: str):
    """|port - JAX| of N_FG foreground and N_BG background pixels of the
    view, and the JAX pixels; the JAX trainer loads the checkpoint as
    tests/test_cp_quality_ckpt.py does and renders those rays alone."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.train.trainer import Trainer as JaxTrainer

    _, val, res = port_view
    opt = jax_load(CP_INI, workspace=workspace, **SMALL_EVAL)
    jt = JaxTrainer(opt, jax_netcfg(opt), workspace=workspace)
    assert jt.load_checkpoint(CKPT)

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
