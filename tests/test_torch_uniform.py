"""The grid-free renderer of the port (``render/uniform.py``): the inverse-CDF
sampler ``sample_pdf`` and ``render_uniform``, against the JAX package on the
same inputs, parameters and draws.

``sample_pdf`` finds each draw's bin by a search of the CDF where the JAX
package counts a ``[N, T+1, S]`` comparison; the two cumsums round their last
ulp differently, so the samples agree to ``PDF_ATOL`` (bins in [0, 4]), and
a draw that lands exactly on a CDF value (where both CDFs hold the same
float) falls into the same bin in both.  ``render_uniform`` runs the small
CP + Laplace model (``configs/synth_spheres_cp_laplace.ini`` cut to test
size, the SDF fitted to a sphere) with its CP encoder in f32, against the
jitted JAX render; the gradient of ``mean(image)`` reaches every leaf, the
coarse query's too when the samples are upsampled (JAX stops no gradient
there)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.render.uniform import UniformRenderOptions as JaxOptions
from envidr_tpu.render.uniform import render_uniform as jax_render_uniform
from envidr_tpu.render.uniform import sample_pdf as jax_sample_pdf
from envidr_tpu_torch.render.uniform import UniformRenderOptions, render_uniform, sample_pdf
from test_torch_helpers import (camera_rays, export_jax_layout, f32_cp_encoder, fitted_model,
                                one_torch_thread_fixture, rel_err)

one_torch_thread = one_torch_thread_fixture()
# readings (this file's cases on the CPU): samples 2.9e-6 at most (z in
# [0, 4]); image, depth, opacity and normal image 4.8e-7; gradients 1.2e-5
# of a leaf's max (the CP projection of level 1); each bound ~8x
PDF_ATOL = 2e-5
IMAGE_ATOL = 4e-6
GRAD_RTOL = 1e-4
N, T, S = 16, 12, 64


def _pdf_inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0.0, 4.0, (N, T + 1)), axis=-1).astype(np.float32)
    if kind == "one_bin":           # all the mass in bin 5 (tests/test_uniform_render.py)
        w = np.zeros((N, T), np.float32)
        w[:, 5] = 100.0
    else:                           # some bins empty
        w = rng.uniform(0.0, 1.0, (N, T)).astype(np.float32)
        w[rng.uniform(size=(N, T)) < 0.4] = 0.0
    return bins, w


@pytest.mark.parametrize("kind", ["mixed", "one_bin"])
@pytest.mark.parametrize("draw", ["det", "random"])
def test_sample_pdf_matches_jax(kind, draw):
    bins, w = _pdf_inputs(kind)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), S,
                                    det=draw == "det"))
    u = None if draw == "det" else torch.tensor(
        np.asarray(jax.random.uniform(key, (N, S))))      # JAX's own draws
    ours = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), S, det=draw == "det",
                      u=u).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PDF_ATOL)
    if kind == "one_bin":
        inside = (ours >= bins[:, 5:6]) & (ours <= bins[:, 6:7])
        assert inside.mean() > 0.95


def test_sample_pdf_draw_on_a_cdf_value_takes_the_bin_above():
    """``u`` equal to a CDF value: JAX counts it among the values at or
    below the draw, as the search does, so the sample is the left edge of
    the bin above the tie."""
    bins, w = _pdf_inputs("mixed", seed=1)
    wj = jnp.asarray(w) + 1e-5
    cdf_j = np.asarray(jnp.cumsum(wj / jnp.sum(wj, -1, keepdims=True), -1))
    wt = torch.from_numpy(w) + 1e-5
    cdf_t = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1).numpy()
    same = cdf_j[:, :-1] == cdf_t[:, :-1]
    tie = same.any(axis=1)                           # rows with an interior CDF value both hold
    assert tie.sum() >= N // 2
    k = same.argmax(axis=1)
    u = np.where(tie, cdf_j[np.arange(N), k], 0.5).astype(np.float32)
    u = np.repeat(u[:, None], S, axis=1)
    with pytest.MonkeyPatch.context() as mp:        # JAX's draws are the ties
        mp.setattr(jax.random, "uniform", lambda *a, **kw: jnp.asarray(u))
        ref = np.asarray(jax_sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                                        jnp.asarray(w), S))
    ours = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), S,
                      u=torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(ours[tie], ref[tie])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PDF_ATOL)
    rows = np.flatnonzero(tie)                       # the left edge of the bin above the tie
    np.testing.assert_array_equal(ours[rows, 0], bins[rows, k[rows] + 1])


def _uniform_case(upsample: int):
    (_, jcfg, params), (_, _, net) = fitted_model(seed=4)
    o, d = camera_rays(32, seed=5)
    aabb = np.asarray([-1.0] * 3 + [1.0] * 3, np.float32)
    kw = dict(num_steps=24, upsample_steps=upsample, perturb=True, training=True)
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)[1], jax.random.split(jax.random.split(key)[0])[1]
    noise = np.asarray(jax.random.uniform(k1, (32, 24)))
    u = np.asarray(jax.random.uniform(k2, (32, upsample))) if upsample else None
    jp = jax.tree.map(jnp.asarray, params)

    def jloss(p):
        out = jax_render_uniform(p, jcfg, JaxOptions(**kw), jnp.asarray(o), jnp.asarray(d),
                                 1.0, jnp.asarray(aabb), key=key)
        return jnp.mean(out["image"]), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    out = render_uniform(net, UniformRenderOptions(**kw), torch.from_numpy(o),
                         torch.from_numpy(d), 1.0, torch.from_numpy(aabb),
                         noise=torch.from_numpy(noise),
                         u=None if u is None else torch.from_numpy(u))
    out["image"].mean().backward()
    return ref, jax.tree.map(np.asarray, jgrads), out, export_jax_layout(net, grads=True)


@pytest.fixture(scope="module", params=[0, 16], ids=["uniform", "upsampled"])
def uniform_case(request):
    with f32_cp_encoder():
        return _uniform_case(request.param)


def test_render_uniform_matches_jax(uniform_case):
    ref, _, out, _ = uniform_case
    for k in ("image", "depth", "weights_sum", "normal_image"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=IMAGE_ATOL, err_msg=k)
    assert out["sigmas"].shape == ref["sigmas"].shape
    # the rays from z = 2.5 meet the fitted sphere (radius 0.95) near depth 1.55
    assert 1.3 < float(out["depth"].detach().mean()) < 2.0


def test_render_uniform_gradients_match_jax(uniform_case):
    _, jgrads, _, ours = uniform_case
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    errs = {}
    for path, a in jax.tree_util.tree_leaves_with_path(jgrads):
        if np.abs(a).max() == 0:         # e.g. the colour head's unused bias rows
            np.testing.assert_array_equal(flat[path], 0.0)
            continue
        errs[jax.tree_util.keystr(path)] = rel_err(a, flat[path])
    assert max(errs.values()) <= GRAD_RTOL, errs
