"""The port's dense march, compositing, grid update and render_scene against
the JAX package on the same rays, occupancy and parameters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.geometry import rays as jrays
from envidr_tpu.ops import compositing as jcomp, grid as jgrid, marching as jmarch
from envidr_tpu.render import scene as jscene
from envidr_tpu_torch.geometry import rays as trays
from envidr_tpu_torch.ops import compositing as tcomp, grid as tgrid, marching as tmarch
from envidr_tpu_torch.render import scene as tscene
from test_torch_helpers import camera_rays, rel_err, shared_model

T = lambda a: torch.tensor(np.asarray(a))              # noqa: E731


def _bitfield(cascades, H, p=0.3, seed=0):
    return (np.random.default_rng(seed).uniform(size=(cascades, H ** 3)) < p)


@pytest.mark.parametrize("bound,perturb", [(1.0, False), (1.0, True), (2.0, False)])
def test_dense_march_matches(bound, perturb):
    H, N = 32, 64
    casc = tgrid.GridSpec(grid_size=H, bound=bound).cascades
    bits = _bitfield(casc, H)
    o, d = camera_rays(N, seed=1)
    o = o * bound
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    nears, fars = jrays.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    key = jax.random.PRNGKey(7) if perturb else None
    kw = dict(bound=bound, grid_size=H, max_steps=256, num_samples=32, early_stop_steps=24)
    ref = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), nears, fars, jnp.asarray(bits),
                            perturb_key=key, **kw)
    noise = T(jax.random.uniform(key, (N,))) if perturb else None
    ours = tmarch.march_rays(T(o), T(d), T(nears), T(fars), T(bits), noise=noise, **kw)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))
    for f in ("xyzs", "dts", "z_vals", "ts"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    assert int(ours.counts.sum()) > 0


def test_near_far_and_pixel_rays_match():
    o, d = camera_rays(50, seed=2)
    d[0] = [0.0, 0.0, -1.0]                              # axis-aligned: 1/0 guard
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jrays.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    tn, tf = trays.near_far_from_aabb(T(o), T(d), T(aabb))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[0, :3, 3] = [0.1, -0.2, 2.0]
    intr = (30.0, 30.0, 8.0, 6.0)
    jo, jd = jrays.full_image_rays(jnp.asarray(pose), intr, 12, 16)
    to, td = trays.full_image_rays(T(pose), intr, 12, 16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    r = trays.sampled_rays(torch.Generator().manual_seed(0), T(pose), intr, 12, 16, 20)
    np.testing.assert_allclose(r["rays_d"][0].numpy(), td[0][r["inds"][0]].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("T_thresh", [0.0, 1e-2])
def test_compositing_matches(T_thresh):
    rng = np.random.default_rng(3)
    sig = rng.uniform(0, 30, (40, 24)).astype(np.float32)
    dts = rng.uniform(0.001, 0.05, (40, 24)).astype(np.float32)
    rgb = rng.uniform(0, 1, (40, 24, 3)).astype(np.float32)
    z = np.cumsum(dts, axis=-1).astype(np.float32)
    ref = jcomp.composite_rays(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dts),
                               jnp.asarray(z), T_thresh=T_thresh)
    ours = tcomp.composite_rays(T(sig), T(rgb), T(dts), T(z), T_thresh=T_thresh)
    for a, b in zip(ref, ours):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_compositing_gradients_match():
    """The transmittance's cumprod backward skips torch's test for zeros (it
    reads a flag back to the host); the gradients still match JAX's, with
    saturated samples (alpha = 1, a factor of 1e-15) included, and equal
    torch's own cumprod backward bit for bit."""
    rng = np.random.default_rng(4)
    sig = rng.uniform(0, 30, (40, 24)).astype(np.float32)
    sig[:5, 3] = 1e6
    dts = rng.uniform(0.001, 0.05, (40, 24)).astype(np.float32)
    rgb = rng.uniform(0, 1, (40, 24, 3)).astype(np.float32)
    z = np.cumsum(dts, axis=-1).astype(np.float32)
    proj = rng.standard_normal(3).astype(np.float32)

    def jax_loss(s, c):
        _, depth, img, _ = jcomp.composite_rays(s, c, jnp.asarray(dts), jnp.asarray(z))
        return (img @ jnp.asarray(proj)).sum() + depth.sum()

    ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(sig), jnp.asarray(rgb))
    s, c = T(sig).requires_grad_(), T(rgb).requires_grad_()
    _, depth, img, _ = tcomp.composite_rays(s, c, T(dts), T(z))
    ((img @ T(proj)).sum() + depth.sum()).backward()
    for a, b in zip(ref, (s.grad, c.grad)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max())
    x = (T(rng.uniform(1e-15, 1, (40, 24)).astype(np.float32))).requires_grad_()
    g = T(rng.standard_normal((40, 24)).astype(np.float32))
    (ours,) = torch.autograd.grad(tcomp._CumprodNoZeros.apply(x), x, g)
    (torchs,) = torch.autograd.grad(torch.cumprod(x, dim=-1), x, g)
    assert torch.equal(ours, torchs)


@pytest.mark.parametrize("fraction", [1, 4])
def test_update_grid_matches(fraction):
    """A density that is constant per cell makes the jitter irrelevant: the
    jittered points never leave their cell."""
    H = 16
    spec_j = jgrid.GridSpec(grid_size=H, bound=1.0, density_thresh=0.5)
    spec_t = tgrid.GridSpec(grid_size=H, bound=1.0, density_thresh=0.5)
    table = np.random.default_rng(4).uniform(0, 1, H ** 3).astype(np.float32)
    half = 1.0 / H

    def cell_of(x, floor):
        c = floor((x + 1.0) / (2 * half))
        return (c[:, 0] * H + c[:, 1]) * H + c[:, 2]

    jfn = lambda x: jnp.asarray(table)[cell_of(x, jnp.floor).astype(jnp.int32)]      # noqa
    tfn = lambda x: T(table)[cell_of(x, torch.floor).long()]                          # noqa
    jg, tg = jgrid.init_grid(spec_j), tgrid.init_grid(spec_t)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        jg = jgrid.update_grid(jg, spec_j, jfn, jax.random.PRNGKey(i), fraction=fraction,
                               chunk=1024)
        tg = tgrid.update_grid(tg, spec_t, tfn, gen, fraction=fraction, chunk=1024)
    np.testing.assert_allclose(tg.density.numpy(), np.asarray(jg.density), rtol=1e-6)
    np.testing.assert_array_equal(tg.bitfield.numpy(), np.asarray(jg.bitfield))
    assert tg.iter_density == int(jg.iter_density) == 3


def test_morton_and_packbits_match():
    c = np.random.default_rng(5).integers(0, 128, (100, 3)).astype(np.int32)
    np.testing.assert_array_equal(tgrid.morton3d(T(c)).numpy(),
                                  np.asarray(jgrid.morton3d(jnp.asarray(c))))
    dens = np.random.default_rng(6).uniform(size=(1, 512)).astype(np.float32)
    np.testing.assert_array_equal(tgrid.packbits(T(dens), 0.5).numpy(),
                                  np.asarray(jgrid.packbits(jnp.asarray(dens), 0.5)))


@pytest.mark.parametrize("training", [False, True])
def test_render_scene_matches(training):
    (_, jcfg, params), (_, _, net) = shared_model(seed=3)
    N = 48
    o, d = camera_rays(N, seed=4)
    bits = _bitfield(1, 128, p=0.6, seed=5)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    kw = dict(max_steps=512, num_samples=32, early_stop_steps=64, T_thresh=1e-4,
              min_near=0.2, training=training)
    ref = jscene.render_scene(jax.tree.map(jnp.asarray, params), jcfg,
                              jscene.SceneRenderOptions(**kw), jnp.asarray(bits),
                              jnp.asarray(o), jnp.asarray(d), 1.0, jnp.asarray(aabb))
    ours = tscene.render_scene(net, tscene.SceneRenderOptions(**kw), T(bits), T(o), T(d),
                               1.0, T(aabb))
    assert int(ours["counts"].sum()) > 0
    np.testing.assert_array_equal(ours["mask"].numpy(), np.asarray(ref["mask"]))
    for k in ("image", "weights_sum", "depth", "normal_image", "diffuse_image",
              "specular_image", "roughness_image"):
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=2e-4, err_msg=k)
    assert rel_err(np.asarray(ref["sdf_gradients"]),
                   ours["sdf_gradients"].detach().numpy()) < 1e-4
