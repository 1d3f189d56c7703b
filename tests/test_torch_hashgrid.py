"""The port's rolled_tiled hash encoder (ops/hashgrid.py) against the JAX
package's hash_encode: forward, first order and the eikonal second order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.ops import hashgrid as jhg
from envidr_tpu_torch.ops import hashgrid as thg
from test_torch_helpers import rel_err

BASE = dict(num_levels=4, level_dim=2, base_resolution=4, desired_resolution=64,
            log2_hashmap_size=12, indexing="rolled_tiled", scatter_impl="mixed")
FWD_ATOL = 1e-6           # one f32 product-sum per output
GRAD1_RTOL = 1e-5         # first order: f32 sums over <= 8 corners x 4 levels
GRAD2_RTOL = 1.3e-3       # second order, rel. to max (ROADMAP C-3)


def _specs(**kw):
    kw = {**BASE, **kw}
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def _inputs(spec, n=300, seed=0, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    emb = rng.uniform(-0.1, 0.1, (spec.table_size, spec.level_dim)).astype(np.float32)
    # by default a few samples lie outside [0, 1]: they encode to zero
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return emb, x


def test_spec_geometry_matches():
    js, ts = _specs(desired_resolution=2048, num_levels=16, log2_hashmap_size=19,
                    base_resolution=16)
    assert js.offsets == ts.offsets and js.resolutions == ts.resolutions
    assert js.scales == ts.scales and js.table_size == ts.table_size


def test_blocked_tables_match():
    js, ts = _specs()
    emb, _ = _inputs(ts)
    ref = np.asarray(jhg.build_blocked_tables(jnp.asarray(emb), js))
    ours = thg.build_blocked_tables(torch.from_numpy(emb), ts).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("custom_grad", [True, False])
@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
def test_forward_and_first_order(custom_grad, interpolation):
    js, ts = _specs(custom_grad=custom_grad, interpolation=interpolation)
    emb, x = _inputs(ts)

    def jloss(e, xx):
        return jnp.sum(jnp.sin(jhg.hash_encode(xx, e, js) * 3.0))

    ref_out = np.asarray(jhg.hash_encode(jnp.asarray(x), jnp.asarray(emb), js))
    ref_de, ref_dx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(x))

    e_t = torch.from_numpy(emb).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = thg.hash_encode(x_t, e_t, ts)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=0, atol=FWD_ATOL)
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and not out.detach().numpy()[oob].any()
    torch.sin(out * 3.0).sum().backward()
    assert rel_err(ref_de, e_t.grad.numpy()) < GRAD1_RTOL
    assert rel_err(ref_dx, x_t.grad.numpy()) < GRAD1_RTOL


@pytest.mark.parametrize("custom_grad", [True, False])
def test_eikonal_second_order(custom_grad):
    """Gradient of an eikonal-style loss on d enc/d x w.r.t. table and x.
    Samples lie inside [0, 1]: outside, d enc/d x is 0 and the norm's
    gradient is 0/0 in JAX's autodiff path."""
    js, ts = _specs(custom_grad=custom_grad)
    emb, x = _inputs(ts, seed=1, lo=0.0, hi=1.0)
    proj = np.random.default_rng(2).standard_normal((ts.output_dim,)).astype(np.float32)

    def jeik(e, xx):
        g = jax.grad(lambda p: jnp.sum(jhg.hash_encode(p, e, js) @ proj))(xx)
        return jnp.sum((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    ref_de, ref_dx = jax.grad(jeik, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(x))

    e_t = torch.from_numpy(emb).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    f = (thg.hash_encode(x_t, e_t, ts) @ torch.from_numpy(proj)).sum()
    (g,) = torch.autograd.grad(f, x_t, create_graph=True)
    ((g.norm(dim=-1) - 1.0) ** 2).sum().backward()
    assert rel_err(ref_de, e_t.grad.numpy()) < GRAD2_RTOL
    assert rel_err(ref_dx, x_t.grad.numpy()) < GRAD2_RTOL


def test_train_step_scatters_twice(monkeypatch):
    """Color + eikonal step: one first-order and one second-order table
    scatter; the normals pass (gated) launches none."""
    _, ts = _specs()
    emb, x = _inputs(ts, seed=3)
    calls = []
    real = thg._scatter_rows

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(thg, "_scatter_rows", counting)
    e_t = torch.from_numpy(emb).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    gate = thg.EncoderGradGate()
    enc = thg.hash_encode(x_t, e_t, ts, gate)
    gate.skip_table_grad = True
    (g,) = torch.autograd.grad(enc.sum(), x_t, create_graph=True)
    gate.skip_table_grad = False
    assert calls == []
    loss = (enc ** 2).sum() + ((g.norm(dim=-1) - 1.0) ** 2).sum()
    loss.backward()
    assert len(calls) == 2


def test_gated_and_ungated_table_grads_agree():
    """Skipping the normals pass's table gradient changes no gradient."""
    _, ts = _specs()
    emb, x = _inputs(ts, seed=4)
    grads = []
    for skip in (False, True):
        e_t = torch.from_numpy(emb).requires_grad_(True)
        x_t = torch.from_numpy(x).requires_grad_(True)
        gate = thg.EncoderGradGate()
        enc = thg.hash_encode(x_t, e_t, ts, gate)
        gate.skip_table_grad = skip
        (g,) = torch.autograd.grad(enc.sum(), x_t, create_graph=True)
        gate.skip_table_grad = False
        ((enc ** 2).sum() + (g ** 2).sum()).backward()
        grads.append((e_t.grad.clone(), x_t.grad.clone()))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_unported_indexing_raises():
    """'hash' and 'rolled_tiled' are ported; any other indexing raises."""
    _, ts = _specs(indexing="tiled")
    emb, x = _inputs(ts)
    with pytest.raises(ValueError, match="indexing"):
        thg.hash_encode(torch.from_numpy(x), torch.from_numpy(emb), ts)
