"""The 16 pixels of shiny3's val view 0 at full resolution (400x400) where
the renv gate opens, rendered from ``assets/shiny3_backsdf_ep40.ckpt``
through the three passes and through one, by the JAX package's eval and by
the port on the CPU.

On the card the indirect branch lowers these pixels against a one-pass
render (ROADMAP C8).  The port is held to JAX here pixel by pixel, and the
same drop is read from JAX's own render: it belongs to the checkpoint.
``tests/indir_readings.py`` (``full_view_gate_pixels``) found the pixels
with the port's full-view render on the CPU."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.geometry.rays import linear_to_srgb as jax_linear_to_srgb
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options, network_config
from envidr_tpu_torch.data.nerf_dataset import NeRFDataset
from envidr_tpu_torch.geometry.rays import full_image_rays
from envidr_tpu_torch.train.metrics import psnr
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import one_torch_thread_fixture
from test_torch_indir_ckpt import NO_PRETRAIN, PIXEL_ATOL, SHINY3_CKPT, SHINY3_DATA, SHINY3_INI

one_torch_thread = one_torch_thread_fixture()
GATE_PIXELS = np.array([68136, 68536, 68936, 70138, 70537, 70538, 70539, 70938, 71739, 73736,
                        74922, 75321, 75322, 75722, 77319, 77719])


def _one_pass(opt):
    return dataclasses.replace(opt, indir_ref_start_iter=-1)


@pytest.fixture(scope="module")
def gate_renders(tmp_path_factory):
    """{(package, passes): linear radiance [16, 3]}, the rays, and the val view."""
    val = NeRFDataset(SHINY3_DATA, "val", scale=0.8)
    rays_o, rays_d = full_image_rays(torch.from_numpy(val.poses[:1]), val.intrinsics,
                                     val.H, val.W)
    o, d = rays_o[0][GATE_PIXELS], rays_d[0][GATE_PIXELS]
    out = {}
    opt = load_options(SHINY3_INI, **NO_PRETRAIN)
    tr = Trainer(opt, network_config(opt), device="cpu")
    tr.load_checkpoint(SHINY3_CKPT)
    single = copy.copy(tr)
    single.opt = _one_pass(tr.opt)
    for passes, t in ((3, tr), (1, single)):
        res = t.render_rays(o, d, bg_color=1.0)
        out[("port", passes)] = res["image"].numpy()
        if passes == 3:
            out["renv_mask"] = res["renv_mask_image"].numpy()
    ws = str(tmp_path_factory.mktemp("jax"))
    jopt = jax_load(SHINY3_INI, workspace=ws, **NO_PRETRAIN)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=ws)
    assert jt.load_checkpoint(SHINY3_CKPT)
    jt1 = copy.copy(jt)
    jt1.opt = _one_pass(jt.opt)
    for passes, t in ((3, jt), (1, jt1)):
        fn = t._eval_fn("scene", t._eval_samples_budget("scene"))
        res = fn(t.state["ema"], t.state["grid"].bitfield, jnp.asarray(o.numpy()[None]),
                 jnp.asarray(d.numpy()[None]), jnp.asarray(1.0, jnp.float32),
                 jnp.asarray([-1.0] * 3 + [1.0] * 3), None, 0, None)
        out[("jax", passes)] = np.asarray(res["image"]).reshape(-1, 3)
    return out, val


def _gate_psnr(img, val):
    """PSNR of the 16 pixels as the trainer's evaluate reads them: sRGB,
    clipped, against the view on a white background."""
    pred = np.clip(np.asarray(jax_linear_to_srgb(jnp.asarray(img))), 0.0, 1.0)
    gt = val.images[0].reshape(-1, 4)[GATE_PIXELS].astype(np.float32) / 255.0
    gt = gt[:, :3] * gt[:, 3:] + (1.0 - gt[:, 3:])
    return psnr(pred, gt)


def test_the_pinned_pixels_open_the_renv_gate(gate_renders):
    out, _ = gate_renders
    assert (out["renv_mask"] > 0.5).all()


@pytest.mark.parametrize("passes", [3, 1])
def test_gate_pixels_match_the_jax_render(gate_renders, passes):
    out, _ = gate_renders
    err = np.abs(out[("port", passes)] - out[("jax", passes)])
    assert err.max() <= PIXEL_ATOL, (err.max(), err.mean())


def test_three_passes_read_below_one_pass_in_jax_too(gate_renders):
    """C8: the drop on the card is the checkpoint's.  JAX's three-pass render
    of these pixels reads below its one-pass render, as the port's does, and
    the indirect branch changes them in both packages."""
    out, val = gate_renders
    p = {k: _gate_psnr(v, val) for k, v in out.items() if k != "renv_mask"}
    assert p[("jax", 3)] < p[("jax", 1)], p
    assert p[("port", 3)] < p[("port", 1)], p
    for pkg in ("jax", "port"):
        assert np.abs(out[(pkg, 3)] - out[(pkg, 1)]).max() > 1e-2, pkg
