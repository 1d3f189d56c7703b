"""Readings behind the tolerances and bars of tests/test_torch_{indirect,
indir_ckpt}.py and of chip_smoke.py's render_shiny3: prints each gap the
tests bound, on the CPU.

    JAX_PLATFORMS=cpu python tests/indir_readings.py

Not a test module (pytest collects ``test_*.py`` only); it reuses their
set-ups.  Several minutes (the JAX package's three-pass render of the whole
shiny3 view at downscale 4).
"""

from __future__ import annotations

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_indir_ckpt as tc  # noqa: E402
import test_torch_indirect as ti  # noqa: E402
from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg  # noqa: E402
from envidr_tpu.geometry.rays import linear_to_srgb  # noqa: E402
from envidr_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from envidr_tpu_torch.train.metrics import psnr  # noqa: E402


def jax_view_psnr(val, workspace: str) -> float:
    """The JAX package's render of val view 0 through its eval path (EMA
    parameters, three passes), to sRGB and clipped as its ``evaluate``
    compares it, against the view on a white background."""
    jopt = jax_load(tc.SHINY3_INI, workspace=workspace, **tc.NO_PRETRAIN, **tc.SMALL_EVAL)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=workspace)
    assert jt.load_checkpoint(tc.SHINY3_CKPT)
    img = jt.render_image(val.poses[0], val.intrinsics, val.H, val.W)["image"]
    pred = np.clip(np.asarray(linear_to_srgb(jax.numpy.asarray(img))), 0, 1)
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    return psnr(pred, gt)


def port_f64_update():
    """The resumed update of tests/test_torch_indir_ckpt.py by the port in
    f64: (parameters before, after) in the JAX layout."""
    from envidr_tpu_torch.models.network import NeRFNetwork
    from envidr_tpu_torch.train.schedules import resolve
    from test_torch_helpers import camera_rays, export_jax_layout

    opt = tc.load_options(tc.SHINY3_INI, num_rays=64, **tc.NO_PRETRAIN)
    cfg = tc.network_config(opt)
    tr = tc.Trainer(opt, cfg, device="cpu", net=NeRFNetwork(cfg).double())
    tr.load_checkpoint(tc.SHINY3_CKPT)
    o, d = camera_rays(64, seed=2)
    rng = np.random.default_rng(2)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
    before = jax.tree.map(np.copy, export_jax_layout(tr.net))
    loss, _, _ = tr.forward_loss(*(torch.from_numpy(a).double() for a in (o, d, gt, bg, pix[:, 3])),
                                 K=tc.K, sched=resolve(opt, 41, 2400))
    loss.backward()
    tr._apply_update()
    return before, export_jax_layout(tr.net)


def full_view_gate_pixels():
    """The pixels of shiny3's val view 0 at full resolution (400x400) where
    the port's three-pass render opens the renv gate: their flat indices
    (tests/test_torch_indir_gate.py pins them)."""
    opt = tc.load_options(tc.SHINY3_INI, **tc.NO_PRETRAIN, eval_ray_chunk=4096)
    tr = tc.Trainer(opt, tc.network_config(opt), device="cpu")
    tr.load_checkpoint(tc.SHINY3_CKPT)
    val = tc.NeRFDataset(tc.SHINY3_DATA, "val", scale=opt.scale)
    res = tr.render_view(val, 0)
    return np.flatnonzero(res["renv_mask_image"].reshape(-1) > 0.5)


def _by_leaf(errs):
    out = {}
    for k, v in errs.items():
        leaf = k.split("[")[0]
        out[leaf] = max(out.get(leaf, 0.0), v)
    return ", ".join(f"{k} {v:.3e}" for k, v in out.items())


def main():
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    for dtype in ("float32", "bfloat16"):
        if dtype == "float32":
            with ti.f32_cp_encoder():
                c = ti._indir_step(jax.jit)
        else:
            with jax.disable_jit():
                c = ti._indir_step(lambda f: f)
        print(f"indir step ({dtype} CP) gradient gap by leaf: "
              f"{_by_leaf(ti._leaf_errors(c['jgrads'], c['tr'].net))}", flush=True)
        print(f"indir step ({dtype} CP): renv gate open on "
              f"{float(c['out']['renv_mask'].float().mean()):.4f} of the samples", flush=True)
    with ti.f32_cp_encoder():
        for kind in ("spheres", "background"):
            r = ti._indirect_render(kind)
            print(f"indirect render ({kind}) gradient gap by leaf: "
                  f"{_by_leaf(ti._leaf_errors(r['jg'], r['net']))}", flush=True)
    with tempfile.TemporaryDirectory() as ws:
        with tc.f32_cp_encoder():
            r = tc._resumed_step(ws)
        gaps = {}
        for leaf in ("encoder", "sdf_density", "sdf_net", "env_net", "renv_net"):
            for path, old in jax.tree_util.tree_leaves_with_path(r["jold"][leaf]):
                new = dict(jax.tree_util.tree_leaves_with_path(r["jnew"][leaf]))[path]
                a = dict(jax.tree_util.tree_leaves_with_path(r["before"][leaf]))[path]
                b = dict(jax.tree_util.tree_leaves_with_path(r["after"][leaf]))[path]
                gaps[leaf] = max(gaps.get(leaf, 0.0), ti.rel_err(new - old, b - a))
        print("resumed update gap by leaf: "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
        with tc.f32_cp_encoder():
            up64 = port_f64_update()
        f64 = {}
        for leaf in ("encoder", "sdf_density", "sdf_net", "env_net"):
            for path, old in jax.tree_util.tree_leaves_with_path(r["jold"][leaf]):
                get = lambda t: dict(jax.tree_util.tree_leaves_with_path(t[leaf]))[path]  # noqa
                u64 = get(up64[1]) - get(up64[0])
                f64[leaf] = (max(f64.get(leaf, (0, 0))[0],
                                 ti.rel_err(u64, get(r["after"]) - get(r["before"]))),
                             max(f64.get(leaf, (0, 0))[1], ti.rel_err(u64, get(r["jnew"]) - old)))
        print("resumed update against the port's f64 step (port f32, JAX f32): "
              + ", ".join(f"{k} {a:.3e} {b:.3e}" for k, (a, b) in f64.items()), flush=True)
    opt = tc.load_options(tc.SHINY3_INI, **tc.NO_PRETRAIN, **tc.SMALL_EVAL)
    tr = tc.Trainer(opt, tc.network_config(opt), device="cpu")
    tr.load_checkpoint(tc.SHINY3_CKPT)
    val = tc.NeRFDataset(tc.SHINY3_DATA, "val", scale=opt.scale, downscale=4)
    res = tr.render_view(val, 0)
    port_psnr = psnr(*tc.eval_pair(res, val, 0, tr.opt))
    with tempfile.TemporaryDirectory() as ws:
        err, _ = tc.shiny3_pixel_errors((tr, val, res), ws)
        print(f"shiny3 view pixels, port vs JAX: max {err.max():.3e}, mean {err.mean():.3e}, "
              f"99th pct {np.percentile(err, 99):.3e}", flush=True)
        jp = jax_view_psnr(val, ws)
    print(f"shiny3 val view 0 at downscale 4: JAX {jp:.4f} dB, port {port_psnr:.4f} dB, "
          f"renv gate on {float(res['renv_mask_image'].mean()):.4f} of the pixels", flush=True)


if __name__ == "__main__":
    main()
