"""Readings behind the tolerances and bars of tests/test_torch_sphere.py,
tests/test_torch_sphere_ckpt.py and chip_smoke.py's render_pretrain and
render_renv: prints each gap the tests bound, and the JAX package's own
readings of the pretrains, on the CPU.

    JAX_PLATFORMS=cpu python tests/sphere_readings.py

Not a test module (pytest collects ``test_*.py`` only); it reuses their
set-ups.  A few minutes (the bf16 JAX step op by op; the 100x100 renders).
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

import test_torch_sphere as ts  # noqa: E402
import test_torch_sphere_ckpt as tc  # noqa: E402
from envidr_tpu_torch.data.env_dataset import generate_env_sphere  # noqa: E402
from envidr_tpu_torch.train.metrics import psnr  # noqa: E402
from envidr_tpu_torch.train.trainer import eval_pair  # noqa: E402
from test_torch_helpers import export_jax_layout, rel_err  # noqa: E402

# the view of chip_smoke.py's render_pretrain, downscaled: its bar is this
# reading less 1 dB
PRETRAIN_READING_SIZE = 100


def _leaf_gaps(jgrads, net):
    ours = dict(jax.tree_util.tree_leaves_with_path(export_jax_layout(net, grads=True)))
    gaps = {}
    for path, a in jax.tree_util.tree_leaves_with_path(jgrads):
        leaf = jax.tree_util.keystr(path).split("]")[0] + "]"
        gaps[leaf] = max(gaps.get(leaf, 0.0), rel_err(a, ours[path]))
    return ", ".join(f"{k} {v:.3e}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1]))


def render_readings():
    for name, enc in (("frequency", ts.FREQ), ("cp", {})):
        with ts.f32_cp_encoder():
            jout, tout, jgrads, net = ts._render_pair(enc, True)
        solid = tout["weights_sum"].detach().numpy() > 1e-3
        gaps = {}
        for key in ts.RENDER_KEYS:
            a, b = np.asarray(jout[key]), tout[key].detach().numpy()
            if key == "normal_image":
                a, b = a[solid], b[solid]
            scale = np.abs(np.asarray(jout["sdfs"])).max() if key == "relsdf" else np.abs(a).max()
            gaps[key] = float(np.abs(a - b).max() / scale)
        print(f"render_sphere ({name}) output gaps: "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])),
              flush=True)
        print(f"render_sphere ({name}) gradient gaps: {_leaf_gaps(jgrads, net)}", flush=True)


def step_readings():
    for epoch, dtype in ((0, "float32"), (5, "float32"), (5, "bfloat16")):
        c = ts.sphere_step_case(epoch, dtype)
        terms = ", ".join(f"{k} {float(c['tterms'][k]):.4e}/{float(v):.4e}"
                          for k, v in c["jterms"].items())
        print(f"sphere step epoch {epoch} {dtype}: terms port/JAX {terms}", flush=True)
        print(f"sphere step epoch {epoch} {dtype}: gradient gaps {_leaf_gaps(c['jgrads'], c['tr'].net)}",
              flush=True)
    jl, jterms, jgrads, tr, loss, tterms = ts.out_of_bound_step()
    terms = ", ".join(f"{k} {float(tterms[k]):.4e}/{float(v):.4e}" for k, v in jterms.items())
    print(f"sphere step with out-of-bound samples: terms port/JAX {terms}; loss "
          f"{float(loss.detach()):.6e}/{float(jl):.6e}", flush=True)
    print(f"sphere step with out-of-bound samples: gradient gaps (the encoder's NaN in JAX) "
          f"{_leaf_gaps(jgrads, tr.net)}", flush=True)


def update_readings():
    with ts.f32_cp_encoder():
        params, steps, _ = ts._updates(ts.SPHERE_INI, {}, [1, 0], jax_grads=True)
        (j1, t1), (j2, t2) = steps
        gaps = [rel_err(j2["env_nets"][i][k][1] - j1["env_nets"][i][k][1],
                        t2["env_nets"][i][k][1] - t1["env_nets"][i][k][1])
                for i in range(len(params["env_nets"])) for k in ("w", "b")]
        print(f"env net 1's momentum-only update, port against optax on JAX's gradients: "
              f"max {max(gaps):.3e}",
              flush=True)
        params, [(jnew, tnew)], _ = ts._updates(ts.RENV_INI, dict(encoding_pos="cp",
                                                                  color_mlp_path=""),
                                                 [1], with_r=True)
        gaps = [rel_err(np.asarray(j) - np.asarray(a), np.asarray(t) - np.asarray(a))
                for j, t, a in zip(jax.tree.leaves(jnew["renv_net"]), jax.tree.leaves(tnew["renv_net"]),
                                   jax.tree.leaves(params["renv_net"]))]
        print(f"train_renv update of renv_net, port against optax: max {max(gaps):.3e}", flush=True)


def card_parity_floor_readings():
    """chip_smoke.py's sphere_parity step on the CPU against itself with one
    f32 ulp of noise on a third of the ray coordinates (four draws): the
    noise floor under which the card's reading can show nothing."""
    import chip_smoke as cs
    import envidr_tpu_torch.render.sphere_probe as sp
    draw = sp.probe_rays
    for n in (cs.SPHERE_PARITY_RAYS, 256):
        cs.SPHERE_PARITY_RAYS = n
        for dtype in ("float32", "bfloat16"):
            floor = 0.0
            for noise in range(5):
                def noisy(*a, noise=noise, **kw):
                    o, d = draw(*a, **kw)
                    if noise:
                        r = np.random.default_rng(noise)
                        o, d = ((x * (1 + r.choice([-1, 0, 1], x.shape) * 2.0**-23))
                                .astype(np.float32) for x in (o, d))
                    return o, d
                sp.probe_rays = noisy
                g = cs._sphere_parity_step("cpu", dtype)
                if not noise:
                    base = g
                    continue
                floor = max(floor, max(float((g[k] - base[k]).abs().max())
                                       / max(float(base[k].abs().max()), 1e-30) for k in g))
            print(f"sphere_parity step, {n} rays, {dtype} encoder: one-ulp ray noise moves "
                  f"it by up to {floor:.3e} of a tensor's max", flush=True)
    sp.probe_rays = draw


def checkpoint_readings():
    with tempfile.TemporaryDirectory() as ws:
        val = generate_env_sphere("val", 1, size=tc.SIZE, device="cpu")
        tr = tc.port_trainer(tc.SPHERE_INI, tc.PRETRAIN_CKPT)
        res = tr.render_view(val, 0)
        ref = tc.jax_sphere_view(tc.SPHERE_INI, tc.PRETRAIN_CKPT, val, ws)
        err = np.abs(res["image"] - ref)
        print(f"pretrain {tc.SIZE}x{tc.SIZE}: pixel gap max {err.max():.3e} mean {err.mean():.3e}; "
              f"PSNR port {psnr(*eval_pair(res, val, 0, tr.opt)):.4f} dB, JAX "
              f"{psnr(*eval_pair({'image': ref}, val, 0, tr.opt)):.4f} dB", flush=True)
        val = tc.downscaled_renv_val()
        tr = tc.port_trainer(tc.RENV_INI, tc.RENV_CKPT, **tc.RENV_CP)
        for with_r in (True, False):
            mine = tr.render_view(val, 0, with_r_image=with_r)["image"]
            ref = tc.jax_sphere_view(tc.RENV_INI, tc.RENV_CKPT, val, ws, with_r, **tc.RENV_CP)
            err = np.abs(mine - ref)
            print(f"renv {tc.SIZE}x{tc.SIZE} {'with' if with_r else 'without'} mirror images: "
                  f"pixel gap max {err.max():.3e} mean {err.mean():.3e}; PSNR port "
                  f"{psnr(*eval_pair({'image': mine}, val, 0, tr.opt)):.4f} dB, JAX "
                  f"{psnr(*eval_pair({'image': ref}, val, 0, tr.opt)):.4f} dB", flush=True)
        # the JAX package's own reading of chip_smoke.py's render_pretrain view
        size = PRETRAIN_READING_SIZE
        val = generate_env_sphere("val", 1, size=size, device="cpu")
        ref = tc.jax_sphere_view(tc.SPHERE_INI, tc.PRETRAIN_CKPT, val, ws)
        print(f"JAX pretrain reading, generated val view 0 at {size}x{size}: "
              f"{psnr(*eval_pair({'image': ref}, val, 0, tr.opt)):.4f} dB", flush=True)


def main():
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    render_readings()
    step_readings()
    update_readings()
    card_parity_floor_readings()
    checkpoint_readings()


if __name__ == "__main__":
    main()
