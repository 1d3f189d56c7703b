"""The trainer's VolSDF error-bound step (``error_bound_sample``) in the
port against the JAX package: the loss terms and every leaf's gradient of
one step of ``configs/synth_spheres_cp_laplace.ini`` cut to test size (4 CP
levels of rank 8, width-16 MLPs, ``num_steps`` 16: 16 + 32 + 2 samples a
ray), its SDF fitted to a sphere, at epoch 1 (the beta cap held, colour,
mask and eikonal terms on), with JAX's draws.

With the CP encoder in f32 the step is held against the jitted JAX step,
sampler included.  With the production bf16 encoder the JAX step is
compiled with XLA's ``xla_allow_excess_precision`` off: by default XLA
drops the bf16 roundings under ``jit`` (trap C3); with it off the compiled
step rounds where the port and the op-by-op JAX step (``jax.disable_jit``,
as ``tests/test_torch_neus.py`` holds the CP step) round, at a fifth of the
op-by-op step's time.  Both bf16 renders take the port's own bf16 samples:
the sampler takes no gradient, its f32 arithmetic is held in
``tests/test_torch_volsdf.py``, and a bf16 SDF query that rounds the other
way moves a bisection, so JAX's own bf16 samples move the step's gradients
by up to 4.6% of a leaf's max.

The JAX trainer's own error-bound step raises (``KeyError: 'counts'``,
``trainer.py:558``: ``render_volsdf`` returns no sample count), so the test
composes JAX's render and losses as that step does
(``tests/test_torch_volsdf.py`` pins the fault)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.ops.density import laplace_beta as jax_laplace_beta
from envidr_tpu.render import volsdf as jvol
from envidr_tpu.train.losses import compute_losses
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu_torch.render import volsdf as tvol
from envidr_tpu_torch.train.schedules import resolve
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (camera_rays, export_jax_layout, f32_cp_encoder, fitted_model,
                                jit_keeping_bf16, one_torch_thread_fixture, rel_err)
from test_torch_volsdf import AABB, jax_draws

one_torch_thread = one_torch_thread_fixture()
# readings (this file's steps on the CPU): loss terms 4.3e-6 relative
# (eikonal, f32), 3.1e-6 (bf16); f32 gradients 4.9e-6 of a leaf's max, bf16
# 5.7e-3 (the CP tables; the bf16 CP step of tests/test_torch_neus.py reads
# 7.3e-3 and is held to the same 2^-6)
TERM_RTOL = 4e-5
STEP_RTOL = 4e-5
BF16_STEP_RTOL = 2.0 ** -6
STEP_OPTS = dict(num_steps=16, error_bound_sample=True)




def _step(dtype: str):
    """One error-bound step's loss and gradients, the port's
    ``Trainer.forward_loss`` against JAX's ``render_volsdf`` and
    ``compute_losses`` composed as the JAX step composes them, at epoch 1
    (the beta cap held, every term on) with JAX's draws."""
    (jopt, jcfg, params), (topt, tcfg, net) = fitted_model(seed=11, **STEP_OPTS)
    o, d = camera_rays(32, seed=12)
    rng = np.random.default_rng(13)
    pix = rng.uniform(0, 1, (32, 4)).astype(np.float32)
    pix[:, 3] = (rng.uniform(size=32) > 0.3).astype(np.float32)
    bg = np.ones((32, 3), np.float32)
    gt = (pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])).astype(np.float32)
    alpha = pix[:, 3].copy()
    jsched = jax_resolve(jopt, 1, 0)
    assert jsched.error_bound
    weights = {k: jnp.asarray(v) for k, v in jsched.weights.items()}
    vkw = dict(num_steps=16, upsample_steps=16, min_near=jopt.min_near, perturb=True,
               training=True)
    key = jax.random.PRNGKey(14)

    def loss_fn(p):
        out = jvol.render_volsdf(p, jcfg, jvol.VolSDFOptions(**vkw), jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(bg), jnp.asarray(AABB), key=key,
                                 beta_cap=weights["_beta_cap"])
        beta = jnp.minimum(jax_laplace_beta(p["sdf_density"], weights["_beta_min"],
                                            jcfg.beta_max), weights["_beta_cap"])
        return compute_losses(out, jnp.asarray(gt), jsched.flags, weights, beta=beta,
                              alpha_mask=jnp.asarray(alpha))

    tr = Trainer(topt, tcfg, device="cpu", net=net)
    sched = resolve(topt, 1, 0)
    assert tr.volsdf_options() == tvol.VolSDFOptions(**vkw)
    samples, sampler = [], tvol.volsdf_sample

    def port_sampler(*a, **kw):
        samples.append(sampler(*a, **kw))
        return samples[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvol, "volsdf_sample", port_sampler)
        tl, out, tterms = tr.forward_loss(*(torch.from_numpy(a) for a in (o, d, gt, bg, alpha)),
                                          K=0, sched=sched,
                                          volsdf_draws=jax_draws(key, 32, vkw))
    tl.backward()
    jp = jax.tree.map(jnp.asarray, params)
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            (jl, jterms), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
        else:                       # keep the bf16 roundings (trap C3)
            mp.setattr(jvol, "volsdf_sample", lambda *a, **kw: jnp.asarray(samples[0].numpy()))
            (jl, jterms), jgrads = jit_keeping_bf16(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return dict(jl=float(jl), jterms=jterms, jgrads=jax.tree.map(np.asarray, jgrads),
                tl=float(tl.detach()), tterms=tterms, out=out,
                grads=export_jax_layout(net, grads=True), dtype=dtype)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def step(request):
    if request.param == "float32":
        with f32_cp_encoder():
            return _step("float32")
    return _step("bfloat16")


def test_error_bound_step_loss_matches_jax(step):
    assert step["out"]["sigmas"].shape == (32, 16 + 32 + 2)
    assert set(step["tterms"]) == set(step["jterms"]) == {"color", "mask", "eikonal"}
    for k, v in step["jterms"].items():
        assert float(step["tterms"][k]) == pytest.approx(float(v), rel=TERM_RTOL), k
    assert step["tl"] == pytest.approx(step["jl"], rel=TERM_RTOL)


def test_error_bound_step_gradients_match_jax(step):
    flat = dict(jax.tree_util.tree_leaves_with_path(step["grads"]))
    errs = {jax.tree_util.keystr(path): rel_err(a, flat[path])
            for path, a in jax.tree_util.tree_leaves_with_path(step["jgrads"])
            if np.abs(a).max() > 0}
    tol = STEP_RTOL if step["dtype"] == "float32" else BF16_STEP_RTOL
    assert max(errs.values()) <= tol, errs
