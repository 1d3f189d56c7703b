"""The port's coarse (two-level) march against the JAX package's, against the
port's own dense march where the segment budget M does not bind, and its
fallback to the dense march."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.geometry import rays as jrays
from envidr_tpu.ops import marching as jmarch
from envidr_tpu_torch.ops import grid as tgrid, marching as tmarch
from test_torch_helpers import camera_rays

T = lambda a: torch.tensor(np.asarray(a))              # noqa: E731
N = 64
TS_ATOL = 1e-5       # f32 t, positions (as the dense march's test holds them)


def _rays(bound, seed=1):
    o, d = camera_rays(N, seed=seed)
    o = o * bound
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    nears, fars = jrays.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    return o, d, np.asarray(nears), np.asarray(fars)


def _ball_bitfield(cascades, H, bound, radius=0.3):
    """Cells whose centre lies within ``radius`` of the origin, per cascade."""
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    rows = []
    for lvl in range(cascades):
        el = min(2.0 ** lvl, bound)
        rows.append((np.sqrt(x * x + y * y + z * z) * el < radius).reshape(-1))
    return np.stack(rows)


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))
    for f in ("xyzs", "dts", "z_vals", "ts"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=TS_ATOL, err_msg=f)


# bound 1: one cascade, grid 32; bound 2: two cascades, grid 64 (a coarse
# cell of 0.25 world units, the dispatcher's limit)
@pytest.mark.parametrize("bound,H,perturb,bits", [
    (1.0, 32, False, "random"), (1.0, 32, True, "random"), (1.0, 32, False, "ball"),
    (2.0, 64, False, "random"), (2.0, 64, True, "ball")])
def test_coarse_march_matches_jax(bound, H, perturb, bits, capsys):
    casc = tgrid.GridSpec(grid_size=H, bound=bound).cascades
    rng = np.random.default_rng(0)
    bitfield = (rng.uniform(size=(casc, H ** 3)) < 0.02 if bits == "random"
                else _ball_bitfield(casc, H, bound))
    o, d, nears, fars = _rays(bound)
    key = jax.random.PRNGKey(7) if perturb else None
    kw = dict(bound=bound, grid_size=H, max_steps=128, num_samples=32, early_stop_steps=24,
              coarse_march=True)
    ref = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                            jnp.asarray(fars), jnp.asarray(bitfield), perturb_key=key, **kw)
    noise = T(jax.random.uniform(key, (N,))) if perturb else None
    ours = tmarch.march_rays(T(o), T(d), T(nears), T(fars), T(bitfield), noise=noise, **kw)
    assert "[march]" not in capsys.readouterr().out      # the coarse path was taken
    _assert_same(ours, ref)
    assert int(ours.counts.sum()) > 0


@pytest.mark.parametrize("bound,H", [(1.0, 32), (2.0, 64)])
def test_coarse_march_equals_dense_where_m_does_not_bind(bound, H, capsys):
    """A ball of occupied cells: each ray crosses a few positive segments,
    far below M, so the coarse path selects the dense path's samples (its
    ``t`` rounds differently: t0 + (seg*S)*dt + j*dt)."""
    casc = tgrid.GridSpec(grid_size=H, bound=bound).cascades
    bitfield = T(_ball_bitfield(casc, H, bound, radius=0.3 * bound))
    o, d, nears, fars = _rays(bound, seed=2)
    kw = dict(bound=bound, grid_size=H, max_steps=128, num_samples=32, early_stop_steps=24)
    args = (T(o), T(d), T(nears), T(fars), bitfield)
    dense = tmarch.march_rays(*args, **kw)
    coarse = tmarch.march_rays(*args, coarse_march=True, **kw)
    assert "[march]" not in capsys.readouterr().out
    _assert_same(coarse, dense)
    assert (dense.counts.numpy() > 0).sum() > N // 4


@pytest.mark.parametrize("bound,H,steps", [
    (2.0, 32, 128),      # coarse cell 0.5 > 0.25
    (1.0, 32, 16),       # stride S = 1: nothing to save
    (1.0, 30, 128),      # grid not a multiple of 4
])
def test_fallback_warns_once_and_marches_dense(bound, H, steps, capsys):
    casc = tgrid.GridSpec(grid_size=H, bound=bound).cascades
    tmarch._COARSE_FALLBACK_WARNED.discard((bound, H, 0.0, casc))
    bitfield = T(np.random.default_rng(3).uniform(size=(casc, H ** 3)) < 0.3)
    o, d, nears, fars = _rays(bound)
    kw = dict(bound=bound, grid_size=H, max_steps=steps, num_samples=16)
    args = (T(o), T(d), T(nears), T(fars), bitfield)
    first = tmarch.march_rays(*args, coarse_march=True, **kw)
    tmarch.march_rays(*args, coarse_march=True, **kw)
    out = capsys.readouterr().out
    assert out.count("[march] coarse_march requested but falling back") == 1
    dense = tmarch.march_rays(*args, **kw)
    for a, b in zip(first, dense):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_steps", [64, 256])
def test_dense_march_noise_step_is_clipped_as_in_jax(max_steps):
    """The perturbed start moves by ``clip(t0 * dt_gamma, dt_min, dt_max)``
    of the noise, as in JAX: with fewer than ``grid_size`` steps on one
    cascade dt_min exceeds dt_max, and the clip gives dt_max (the tiny CP
    step's 64 steps on a 128 grid)."""
    H, bound = 128, 1.0
    bitfield = np.random.default_rng(3).uniform(size=(1, H ** 3)) < 0.3
    o, d, nears, fars = _rays(bound)
    key = jax.random.PRNGKey(5)
    ref = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                            jnp.asarray(fars), jnp.asarray(bitfield), bound=bound, grid_size=H,
                            max_steps=max_steps, num_samples=8, early_stop_steps=8,
                            perturb_key=key)
    ours = tmarch.march_rays(T(o), T(d), T(nears), T(fars), T(bitfield), bound=bound,
                             grid_size=H, max_steps=max_steps, num_samples=8,
                             early_stop_steps=8, noise=T(jax.random.uniform(key, (N,))))
    _assert_same(ours, ref)
