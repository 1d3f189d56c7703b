"""Readings behind the tolerances and bars of tests/test_torch_{ours,aux,
laplace_ckpt}.py and of chip_smoke.py's render_laplace: prints each gap the
tests bound, on the CPU.

    JAX_PLATFORMS=cpu python tests/ours_readings.py

Not a test module (pytest collects ``test_*.py`` only); it reuses their
set-ups.  A few minutes (the JAX render of the whole Laplace view).
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

import test_torch_aux as ta  # noqa: E402
import test_torch_laplace_ckpt as tl  # noqa: E402
import test_torch_ours as to  # noqa: E402
from envidr_tpu_torch.models import network as tnet  # noqa: E402
from envidr_tpu_torch.train.schedules import resolve  # noqa: E402
from test_torch_helpers import export_jax_layout, f32_cp_encoder, rel_err  # noqa: E402


def _gaps(jax32, port32, port64):
    """Per top-level leaf: max rel_err of port f32 vs JAX f32, port f32 vs
    port f64 and JAX f32 vs port f64."""
    out = {}
    for leaf in jax32:
        a = dict(jax.tree_util.tree_leaves_with_path(jax32[leaf]))
        b = dict(jax.tree_util.tree_leaves_with_path(port32[leaf]))
        c = dict(jax.tree_util.tree_leaves_with_path(port64[leaf]))
        out[leaf] = tuple(max(rel_err(x[k], y[k]) for k in a)
                          for x, y in ((a, b), (c, b), (c, a)))
    return out


def _print_gaps(title, gaps):
    for leaf, (pj, p64, j64) in gaps.items():
        print(f"{title} {leaf}: port32 vs jax32 {pj:.3e}, port32 vs port64 {p64:.3e}, "
              f"jax32 vs port64 {j64:.3e}", flush=True)


class _PreActs:
    """Records the pre-activations of every hidden layer of the colour
    branch's MLPs (env, diffuse, specular)."""

    def __init__(self):
        self.seen, self.orig = [], tnet.apply_mlp

    def __call__(self, layers, x, act=torch.nn.functional.relu):
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                self.seen.append(x.detach().double().clone())
                x = act(x)
        return x


def _ours_inputs():
    o, d = to.camera_rays(64, seed=4)
    rng = np.random.default_rng(5)
    pix = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=64) > 0.4).astype(np.float32)
    bg = np.ones((64, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    bits = np.random.default_rng(6).uniform(size=(1, 128 ** 3)) < 0.6
    return (o, d, gt, bg, pix[:, 3].copy()), bits


def ours_step_readings():
    """The small ours step (tests/test_torch_ours.py): each leaf's gradient
    gaps, and the 160-wide env net's ReLU masks that flip between f32 and f64."""
    with f32_cp_encoder():
        c = to._frozen_step(tempfile.mkdtemp())
        args, bits = _ours_inputs()
        grads, masks = {}, {}
        for dtype in (torch.float32, torch.float64):
            _, tr, _ = to._models(tempfile.mkdtemp(), seed=5)
            tr.net.to(dtype)
            tr.grid = tr.grid._replace(bitfield=torch.from_numpy(bits))
            spy = _PreActs()
            tnet.apply_mlp = spy
            try:
                loss, _, _ = tr.forward_loss(*(torch.from_numpy(a).to(dtype) for a in args),
                                             K=to.K, sched=resolve(tr.opt, 1, to.GLOBAL_STEP))
            finally:
                tnet.apply_mlp = spy.orig
            loss.backward()
            grads[dtype] = export_jax_layout(tr.net, grads=True)
            masks[dtype] = spy.seen
    _print_gaps("ours step", _gaps(c["jgrads"], c["tgrads"], grads[torch.float64]))
    _print_flips("ours step", masks)


def _print_flips(title, masks):
    flips = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(masks[torch.float32],
                                                            masks[torch.float64])]
    near = min(float(b.abs().min()) for b in masks[torch.float64])
    print(f"{title}: colour-branch ReLU flips f32 vs f64 by hidden layer {flips}, "
          f"smallest |pre-activation| {near:.3e}", flush=True)


def aux_render_readings():
    """The aux render step of tests/test_torch_aux.py, plain and jittered."""
    for stratified in (False, True):
        masks = {}
        with f32_cp_encoder():
            c = ta._aux_render(stratified)
            port32 = export_jax_layout(c["net"], grads=True)
            for dtype in (torch.float32, torch.float64):
                net = c["net"].to(dtype)
                for p in net.parameters():
                    p.grad = None
                spy = _PreActs()
                tnet.apply_mlp = spy
                try:
                    loss = ta.aux_port_loss(net, c["inputs"], dtype)[0]
                finally:
                    tnet.apply_mlp = spy.orig
                masks[dtype] = spy.seen
            loss.backward()
            port64 = export_jax_layout(net, grads=True)
        title = f"aux render stratified={stratified}"
        _print_gaps(title, _gaps(c["jgrads"], port32, port64))
        _print_flips(title, masks)


def aux_term_readings():
    """Each auxiliary term's largest gradient gap, port against JAX."""
    gaps = {}
    for case in sorted(ta.AUX_CASES):
        c = ta.aux_term_case(case)
        gaps[case] = max(rel_err(a, c["tgrads"][k]) for k, a in c["jgrads"].items()
                         if np.abs(a).max() > 0)
    print("aux terms, largest gradient gap by case: "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()), flush=True)


def cue_readings():
    """Three cue steps: the losses of both and the largest parameter gap."""
    import pathlib
    c = ta.cue_case(pathlib.Path(tempfile.mkdtemp()))
    print(f"cue: port losses {c['losses']}, JAX last loss {c['jloss']!r}, rel gap "
          f"{abs(c['losses'][-1] - c['jloss']) / c['jloss']:.3e}; largest parameter gap "
          f"after 3 steps {c['param_gap']:.3e}", flush=True)


def laplace_checkpoint_readings():
    """The Laplace checkpoint's val view 0 at downscale 4: the JAX package's
    PSNR (the bar of tests/test_torch_laplace_ckpt.py and of chip_smoke.py's
    render_laplace), the port's, and the 256 pixels against JAX."""
    view = tl.render_port_view()
    _, val, res = view
    with tempfile.TemporaryDirectory() as workspace:
        jt = tl.jax_trainer(workspace)
        ref = jt.render_image(val.poses[0], val.intrinsics, val.H, val.W, use_ema=False)
        err, _ = tl.pixel_errors(view, workspace)
    print(f"laplace checkpoint PSNR at {val.H}x{val.W}: JAX {tl.view_psnr(val, ref['image']):.4f}"
          f" dB, port {tl.view_psnr(val, res['image']):.4f} dB", flush=True)
    print(f"laplace checkpoint pixels vs JAX: max {err.max():.3e}, mean {err.mean():.3e}, "
          f"99th percentile {np.percentile(err, 99):.3e}", flush=True)


if __name__ == "__main__":
    ours_step_readings()
    aux_render_readings()
    aux_term_readings()
    cue_readings()
    laplace_checkpoint_readings()
