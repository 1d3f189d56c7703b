"""VolSDF's error-bound sampling in the port (``render/volsdf.py``) against
the JAX package on the same parameters, rays and draws; the trainer's
error-bound step is ``tests/test_torch_volsdf_step.py``.

The model is ``configs/synth_spheres_cp_laplace.ini`` cut to test size (4 CP
levels of rank 8, width-16 MLPs), its CP encoder in f32 and its SDF fitted
to a sphere, so that the sampler has a surface to find.  The sampler takes
no gradient (JAX stops it at every query); its samples are held to JAX's in
the deterministic mode, and the render's outputs and gradients with JAX's
own draws of a training render.  JAX's own error-bound train step raises
(``KeyError: 'counts'``); the port's trains."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.render import volsdf as jvol
from envidr_tpu.train.schedules import resolve as jax_resolve
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.render import volsdf as tvol
from envidr_tpu_torch.train.trainer import Trainer
from test_torch_helpers import (CP_LAPLACE_INI, CP_SMALL, camera_rays, export_jax_layout,
                                f32_cp_encoder, fitted_model, one_torch_thread_fixture,
                                rel_err)

one_torch_thread = one_torch_thread_fixture()
AABB = np.asarray([-1.0] * 3 + [1.0] * 3, np.float32)
SMALL_OPTS = dict(num_steps=16, upsample_steps=16, n_samples_extra=8, grow_iters=2,
                  beta_iters=5)
# readings (this file's cases on the CPU): d* one f32 ulp (1.5e-8, one of
# 2496 values); the error bound 5.3e-7 relative; the deterministic samples
# 7.2e-7 (depths 1-3); the render's image, depth, opacity and normal image
# 4.8e-7; its gradients 3.8e-5 of a leaf's max (the CP tables); each bound
# ~8x
D_STAR_ATOL = 1e-7
BOUND_RTOL = 4e-6
Z_ATOL = 6e-6
IMAGE_ATOL = 4e-6
GRAD_RTOL = 3e-4


def test_d_star_and_error_bound_match_jax():
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(1.0, 3.0, (64, 40)), axis=-1).astype(np.float32)
    sdf = (rng.normal(0, 0.05, (64, 40)) + np.linspace(0.3, -0.3, 40)).astype(np.float32)
    ref = np.asarray(jvol._d_star(jnp.asarray(z), jnp.asarray(sdf)))
    ours = tvol._d_star(torch.from_numpy(z), torch.from_numpy(sdf)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=D_STAR_ATOL)
    assert (ours == 0).any() and (ours > 0).any()
    d_star, dists = ref, np.diff(z, axis=-1)        # both packages on JAX's d*
    for beta in (np.full((1, 1), 0.05, np.float32),
                 rng.uniform(0.01, 0.2, (64, 1)).astype(np.float32)):
        ref = np.asarray(jvol._error_bound(*(jnp.asarray(a) for a in (beta, sdf, dists, d_star))))
        ours = tvol._error_bound(*(torch.from_numpy(a) for a in (beta, sdf, dists, d_star)))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=BOUND_RTOL, atol=0)


@pytest.fixture(scope="module")
def model():
    """The fitted model with its CP encoder in f32 (the net takes its
    encoder's dtype when it is built)."""
    with f32_cp_encoder():
        return fitted_model(seed=7)


def _near_far(o, d):
    from envidr_tpu.geometry.rays import near_far_from_aabb
    nears, fars = near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB), 0.2)
    miss = fars > 1e9
    return jnp.where(miss, 2.0, nears), jnp.where(miss, 2.001, fars)


def test_volsdf_sample_matches_jax(model, monkeypatch):
    """The deterministic sampler, its SDF queried in chunks of 200 points
    (eight rays of 16, 32 or 48 samples, four of 64 or 80)."""
    (_, jcfg, params), (_, _, net) = model
    monkeypatch.setattr(tvol, "QUERY_POINTS", 200)
    o, d = camera_rays(32, seed=8)
    o[:4] += np.float32([3.0, 0.0, 0.0])           # four rays miss the box
    nears, fars = _near_far(o, d)
    with f32_cp_encoder():
        ref = jax.jit(lambda p: jvol.volsdf_sample(
            p, jcfg, jvol.VolSDFOptions(**SMALL_OPTS), jnp.asarray(o), jnp.asarray(d), nears,
            fars, jnp.asarray(AABB)))(jax.tree.map(jnp.asarray, params))
        ours = tvol.volsdf_sample(net, tvol.VolSDFOptions(**SMALL_OPTS),
                                  torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(np.asarray(nears)),
                                  torch.from_numpy(np.asarray(fars)), torch.from_numpy(AABB))
    assert ours.shape == (32, 16 + 8 + 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=Z_ATOL)
    # the samples gather about the surface (the sphere of radius 0.95, near depth 1.55)
    hit = np.asarray(fars)[4:] < 1e9
    assert np.median(np.abs(ours.numpy()[4:] - 1.55)) < 0.3


def jax_draws(key, n_rays: int, opts: dict):
    """The draws of a JAX training render: the jitter, the final draw and
    the extra samples' permutation, from the key chain of volsdf_sample
    (``opts``: the VolSDFOptions' fields, defaults filled in)."""
    opts = dataclasses.asdict(jvol.VolSDFOptions(**opts))
    key, sub = jax.random.split(key)
    noise = jax.random.uniform(sub, (n_rays, opts["num_steps"]))
    for _ in range(opts["grow_iters"]):
        key, _ = jax.random.split(key)
    key, sub = jax.random.split(key)
    u = jax.random.uniform(sub, (n_rays, opts["upsample_steps"]))
    key, sub = jax.random.split(key)
    perm = jax.random.permutation(sub, opts["num_steps"] * (1 + opts["grow_iters"]))
    return {k: torch.tensor(np.asarray(v)) for k, v in dict(noise=noise, u=u, perm=perm).items()}


def _render_case(model):
    (_, jcfg, params), (_, _, net) = model
    o, d = camera_rays(24, seed=9)
    kw = dict(SMALL_OPTS, perturb=True, training=True)
    key = jax.random.PRNGKey(10)

    def jloss(p):
        out = jvol.render_volsdf(p, jcfg, jvol.VolSDFOptions(**kw), jnp.asarray(o),
                                 jnp.asarray(d), 1.0, jnp.asarray(AABB), key=key)
        return jnp.mean(out["image"]) + 0.1 * jnp.mean(out["sdf_gradients"] ** 2), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    net.zero_grad(set_to_none=True)
    out = tvol.render_volsdf(net, tvol.VolSDFOptions(**kw), torch.from_numpy(o),
                             torch.from_numpy(d), 1.0, torch.from_numpy(AABB),
                             **jax_draws(key, 24, kw))
    (out["image"].mean() + 0.1 * (out["sdf_gradients"] ** 2).mean()).backward()
    grads = export_jax_layout(net, grads=True)
    net.zero_grad(set_to_none=True)
    return ref, jax.tree.map(np.asarray, jgrads), out, grads


@pytest.fixture(scope="module")
def render_case(model):
    with f32_cp_encoder():
        return _render_case(model)


def test_render_volsdf_matches_jax(render_case):
    ref, _, out, _ = render_case
    assert out["sigmas"].shape == ref["sigmas"].shape == (24, 16 + 8 + 2)
    for k in ("image", "depth", "weights_sum", "normal_image"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=IMAGE_ATOL, err_msg=k)


def test_render_volsdf_gradients_match_jax(render_case):
    _, jgrads, _, ours = render_case
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(jgrads):
        if np.abs(a).max() == 0:
            np.testing.assert_array_equal(flat[path], 0.0)
            continue
        errs[jax.tree_util.keystr(path)] = rel_err(a, flat[path])
    assert max(errs.values()) <= GRAD_RTOL, errs


def test_jax_error_bound_step_raises_and_the_port_trains(tmp_path):
    """JAX's jitted error-bound step asks its render for a sample count
    that ``render_volsdf`` does not return; the port's trainer takes the
    step, draws its own samples, and leaves the mean count as it was."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu_torch.config import load_options as torch_load
    from envidr_tpu_torch.config import network_config as torch_netcfg
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    kw = dict(CP_SMALL, num_steps=16, error_bound_sample=True)
    jopt = jax_load(CP_LAPLACE_INI, workspace=str(tmp_path), **kw)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path),
                    params=fitted_model(seed=7)[0][2])
    jsched = jax_resolve(jopt, 1, 0)
    step_fn = jt._get_train_step(jsched, 16, 64, 8, 8, 4, "scene")
    batch = {"pose": jnp.eye(4).at[2, 3].set(2.5), "image": jnp.zeros((64, 4), jnp.uint8),
             "intrinsics": jnp.asarray([8.0, 8.0, 4.0, 4.0]), "img_idx": jnp.asarray(0)}
    with pytest.raises(KeyError, match="counts"):
        step_fn(jt.state, batch, jax.random.PRNGKey(0),
                {k: jnp.asarray(v) for k, v in jsched.weights.items()})
    topt = torch_load(CP_LAPLACE_INI, **kw)
    tr = Trainer(topt, torch_netcfg(topt), device="cpu")
    data = SynthSpheres("train", size=24, n=2, scale=topt.scale)
    ms = [tr.train_step(data) for _ in range(2)]
    assert all(np.isfinite(float(m["loss"])) for m in ms) and "mean_count" not in ms[0]
    assert tr._sched.error_bound and float(tr.mean_count) == -1.0
    assert int(tr.applied_steps) == 2 and int(tr.notfinite) == 0
