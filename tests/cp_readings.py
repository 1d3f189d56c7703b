"""Readings behind the CP path's tolerances in tests/test_torch_{cp,neus,
cp_ckpt}.py: prints each gap the tests bound, on the CPU.

    JAX_PLATFORMS=cpu python tests/cp_readings.py

Not a test module (pytest collects ``test_*.py`` only); it reuses their
set-ups.  About two minutes.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_cp as tc  # noqa: E402
import test_torch_neus as tn  # noqa: E402
from envidr_tpu.ops import cp as jcp  # noqa: E402
from envidr_tpu_torch.ops import cp as tcp  # noqa: E402
from test_torch_helpers import rel_err  # noqa: E402


def _leaf_errs(a, b):
    """max rel_err over each top-level leaf's tensors of two gradient pytrees."""
    out = {}
    for leaf in a:
        pa = dict(jax.tree_util.tree_leaves_with_path(a[leaf]))
        pb = dict(jax.tree_util.tree_leaves_with_path(b[leaf]))
        out[leaf] = max(rel_err(pa[k], pb[k]) for k in pa)
    return out


def encoder_readings():
    """bf16 two-hot CP encoder: port against JAX, first and second order, and
    JAX's own bf16-against-f32 gap of the second order (seeds 1-3)."""
    for seed in (1, 2, 3):
        js, ts, params, x, rng = tc._case("bfloat16", "twohot", seed)
        cot = rng.standard_normal((tc.N, js.output_dim)).astype(np.float32)
        w = rng.standard_normal((js.output_dim,)).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, params)
        js32 = jcp.CPSpec(**tc.SMALL, compute_dtype="float32")

        g1 = jax.grad(lambda p, xx: jnp.sum(jcp.cp_encode(xx, p, js) * cot),
                      argnums=(0, 1))(jp, jnp.asarray(x))
        tp = tc._torch_params(params)
        tx = torch.tensor(x, requires_grad=True)
        t1 = torch.autograd.grad((tcp.cp_encode(tx, tp, ts) * torch.from_numpy(cot)).sum(),
                                 [*tc._leaves(tp), tx])
        first = max(rel_err(a, b) for a, b in zip([*tc._leaves(g1[0]), g1[1]], t1))

        def eik(p, xx, spec):
            gx = jax.grad(lambda y: jnp.sum(jcp.cp_encode(y, p, spec) @ w))(xx)
            return jnp.sum((jnp.linalg.norm(gx, axis=-1) - 1.0) ** 2)

        j16 = jax.grad(eik)(jp, jnp.asarray(x), js)
        j32 = jax.grad(eik)(jp, jnp.asarray(x), js32)
        tx = torch.tensor(x, requires_grad=True)
        f = (tcp.cp_encode(tx, tp, ts) @ torch.from_numpy(w)).sum()
        (gx,) = torch.autograd.grad(f, tx, create_graph=True)
        t2 = torch.autograd.grad(((gx.norm(dim=-1) - 1.0) ** 2).sum(), tc._leaves(tp))
        second = max(rel_err(a, b) for a, b in zip(tc._leaves(j16), t2))
        gap = max(rel_err(a, b) for a, b in zip(tc._leaves(j16), tc._leaves(j32)))
        print(f"encoder seed {seed}: first order port vs JAX {first:.3e}; second order "
              f"tables port vs JAX {second:.3e}, JAX bf16 vs f32 {gap:.3e}", flush=True)


def step_readings():
    """The small CP step: port against JAX op by op and against JAX compiled
    keeping its roundings (bf16, the test's reference), JAX jitted by default
    and so compiled against op by op (bf16), and the port's f32 step against
    the jitted JAX one."""
    with jax.disable_jit():
        eager = tn._cp_step(lambda f: f)
    kept = tn.cp_step_case("bfloat16")
    jitted = tn._cp_step(jax.jit)
    f32 = tn.cp_step_case("float32")
    ours = tn.export_jax_layout(eager["tr"].net, grads=True)
    ours_kept = tn.export_jax_layout(kept["tr"].net, grads=True)
    ours32 = tn.export_jax_layout(f32["tr"].net, grads=True)
    for name, (a, b) in {"bf16 port vs JAX op by op": (eager["jgrads"], ours),
                         "bf16 port vs JAX without excess precision": (kept["jgrads"], ours_kept),
                         "bf16 JAX jit vs JAX op by op": (jitted["jgrads"], eager["jgrads"]),
                         "bf16 JAX without excess precision vs op by op": (kept["jgrads"],
                                                                           eager["jgrads"]),
                         "f32 port vs JAX jit": (f32["jgrads"], ours32)}.items():
        errs = _leaf_errs(a, b)
        print(f"step {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def checkpoint_readings():
    """PSNR of val view 0 at downscale 4 and the 256 pixels against JAX."""
    import tempfile

    import test_torch_cp_ckpt as tk
    from envidr_tpu_torch.train.metrics import psnr

    view = tk.render_port_view()
    _, val, res = view
    gt = val.images[0].astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    print(f"checkpoint PSNR at {val.H}x{val.W}: {psnr(res['image'], gt):.4f} dB", flush=True)
    with tempfile.TemporaryDirectory() as workspace:
        err, _ = tk.pixel_errors(view, workspace)
    print(f"checkpoint pixels vs JAX: max {err.max():.3e}, mean {err.mean():.3e}, "
          f"99th percentile {np.percentile(err, 99):.3e}", flush=True)


if __name__ == "__main__":
    encoder_readings()
    step_readings()
    checkpoint_readings()
