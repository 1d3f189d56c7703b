"""The port's ``hash`` indexing and ``sorted`` scatter (ops/hashgrid.py)
against the JAX package: forward, first and second order, the row indices
bit for bit, and the network with ``encoding_pos=hashgrid|hashgrid_diff``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.models import network as jnet
from envidr_tpu.ops import hashgrid as jhg
from envidr_tpu_torch.ops import hashgrid as thg
from test_torch_helpers import export_jax_layout, rel_err, shared_model

# 6 levels over 2^14-row tables: levels 0-1 dense (res 8, 24), 2-5 hashed;
# the finest resolution is 2048, so grid positions near x = 1 times the primes
# exceed 2^31 (and 2^32)
BASE = dict(num_levels=6, level_dim=2, base_resolution=8, desired_resolution=2048,
            log2_hashmap_size=14, indexing="hash")
FWD_ATOL = 1e-6           # one f32 product-sum of 8 corners per output
GRAD1_RTOL = 1e-5         # first order: f32 sums over 8 corners x 6 levels
GRAD2_RTOL = 1.3e-3       # second order, rel. to max (ROADMAP C-3)
SORTED_ATOL = 1e-4        # cumsum differences, the JAX package's own bound
                          # (tests/test_pallas_scatter.py:49-50)


def _specs(**kw):
    kw = {**BASE, **kw}
    return jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)


def _inputs(spec, n=300, seed=0, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    emb = rng.uniform(-0.1, 0.1, (spec.table_size, spec.level_dim)).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:8] = np.float32(1.0) - np.float32(6e-8) * np.arange(1, 25).reshape(8, 3)
    return emb, x


def _numpy_fast_hash_indices(spec, x):
    """hashencoder.cu:35-72 in numpy uint32 (wrapping by the type itself)."""
    out = np.zeros((spec.num_levels, x.shape[0], 8), np.int64)
    for l in range(spec.num_levels):
        pg = np.floor(x * np.float32(spec.scales[l])).astype(np.uint32)
        res, hm = np.uint32(spec.resolutions[l]), np.uint32(spec.sizes[l])
        for c in range(8):
            cp = pg + np.array([(c >> d) & 1 for d in range(3)], np.uint32)
            if int(res) ** 3 <= int(hm):
                idx = cp[:, 0] + cp[:, 1] * res + cp[:, 2] * res * res
            else:
                idx = (cp[:, 0] * np.uint32(1)) ^ (cp[:, 1] * np.uint32(2654435761)) \
                    ^ (cp[:, 2] * np.uint32(805459861))
            out[l, :, c] = idx % hm
    return out


def test_indices_bit_equal_to_uint32_hash():
    _, ts = _specs()
    _, x = _inputs(ts, n=500, lo=0.0, hi=1.0)
    with np.errstate(over="ignore"):
        ref = _numpy_fast_hash_indices(ts, x)
    ours = thg.hash_grid_indices(ts, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, ref)
    top = int(np.floor(x * np.float32(ts.scales[-1])).max())
    assert top * 805459861 > 2**32           # products wrap in uint32


def test_indices_match_jax_gather_rows():
    """The rows JAX's hash_encode reads (the support of d out / d table, one
    sample at a time) are the rows of the port's indices, with the port's
    weights: a wrong index anywhere moves a whole weight to another row."""
    js, ts = _specs()
    emb, x = _inputs(ts, n=64, lo=0.0, hi=1.0)

    def f(e):
        return jhg.hash_encode(jnp.asarray(x), e, js)[:, 0::2].sum(-1)   # [B]

    jac = np.asarray(jax.jacrev(f)(jnp.asarray(emb)))[..., 0]              # [B, T]
    idx = thg.hash_grid_indices(ts, torch.from_numpy(x)).numpy()           # [L, B, 8]
    ours = np.zeros_like(jac, dtype=np.float64)
    # weights per corner from the port's own geometry
    scales = np.float32(ts.scales)[:, None, None]
    f_ = x[None] * scales - np.floor(x[None] * scales)
    s = f_ * f_ * (3.0 - 2.0 * f_)
    for l in range(ts.num_levels):
        for c in range(8):
            bits = [(c >> d) & 1 for d in range(3)]
            wc = np.prod([s[l, :, d] if b else 1.0 - s[l, :, d]
                          for d, b in enumerate(bits)], axis=0)
            np.add.at(ours, (np.arange(x.shape[0]), ts.offsets[l] + idx[l, :, c]), wc)
    np.testing.assert_array_equal(jac != 0, ours != 0)
    np.testing.assert_allclose(jac, ours, rtol=0, atol=1e-6)


@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
def test_forward_and_first_order(interpolation):
    js, ts = _specs(interpolation=interpolation)
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


@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
def test_eikonal_second_order(interpolation):
    """d/d(table, x) of an eikonal-style loss on d enc/d x (autograd's
    double backward; samples inside [0, 1])."""
    js, ts = _specs(interpolation=interpolation)
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


def test_sorted_matches_jax_and_index_add():
    L, B, S, W = 3, 5000, 4096, 16
    rng = np.random.default_rng(3)
    idx = rng.integers(0, S, (L, B)).astype(np.int32)
    rows = (rng.standard_normal((L, B, W)) * 1e-2).astype(np.float32)
    ref = np.asarray(jhg._sorted_segment_rows(jnp.asarray(idx), jnp.asarray(rows), S))
    ours = thg._sorted_segment_rows(torch.from_numpy(idx).long(), torch.from_numpy(rows), S)
    plain = torch.zeros(L, S, W)
    for l in range(L):
        plain[l].index_add_(0, torch.from_numpy(idx[l]).long(), torch.from_numpy(rows[l]))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=SORTED_ATOL)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=0, atol=SORTED_ATOL)
    empty = ~np.isin(np.arange(S), idx[0])
    assert np.abs(ours[0].numpy()[empty]).max() < SORTED_ATOL


def test_sorted_training_scale_precision():
    """tests/test_pallas_scatter.py:53 at its size: B = 2^20 non-zero-mean
    rows into 2^18 slots; the compensated chunked prefix must stay within
    2e-5 of an f64 scatter (a global cumsum was off by 2.2e-3)."""
    rng = np.random.default_rng(7)
    B, S, W = 1 << 20, 1 << 18, 2
    idx = rng.integers(0, S, B).astype(np.int32)
    rows = (rng.normal(0, 1e-2, (B, W)) + 5e-3).astype(np.float32)
    ours = thg._sorted_segment_rows(torch.from_numpy(idx[None]).long(),
                                    torch.from_numpy(rows[None]), S)[0].numpy()
    ref = np.zeros((S, W), np.float64)
    np.add.at(ref, idx, rows.astype(np.float64))
    assert np.abs(ours - ref).max() < 2e-5


def test_sorted_encoder_grads_match_jax():
    """Encoder gradients under scatter_impl='sorted' (rolled_tiled, hand-
    written VJP) against the JAX package's, first and second order."""
    kw = dict(num_levels=6, level_dim=2, base_resolution=4, desired_resolution=64,
              log2_hashmap_size=10, interpolation="smoothstep",
              indexing="rolled_tiled", scatter_impl="sorted")
    js, ts = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    rng = np.random.default_rng(4)
    emb = rng.uniform(-1e-1, 1e-1, (ts.table_size, 2)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (257, 3)).astype(np.float32)

    def loss2(e):
        g = jax.grad(lambda xx: jnp.sum(jhg.hash_encode(xx, e, js) ** 2))(jnp.asarray(x))
        return jnp.sum(jhg.hash_encode(jnp.asarray(x), e, js) ** 2) + jnp.sum(g ** 2)

    ref = np.asarray(jax.grad(loss2)(jnp.asarray(emb)))
    e_t = torch.from_numpy(emb).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    enc = thg.hash_encode(x_t, e_t, ts)
    (g,) = torch.autograd.grad((enc ** 2).sum(), x_t, create_graph=True)
    ((enc ** 2).sum() + (g ** 2).sum()).backward()
    assert rel_err(ref, e_t.grad.numpy()) < GRAD2_RTOL


@pytest.mark.parametrize("encoding_pos", ["hashgrid_diff", "hashgrid"])
def test_geometry_with_normals_hash_configs(encoding_pos):
    """The network with the hash encoder in f32: SDF, features and normals,
    and the eikonal gradients of every parameter, against JAX."""
    (_, jcfg, params), (_, tcfg, net) = shared_model(seed=5, encoding_pos=encoding_pos)
    assert tcfg.hash_spec.indexing == jcfg.hash_spec.indexing == "hash"
    assert tcfg.hash_spec.interpolation == jcfg.hash_spec.interpolation
    xyz = np.random.default_rng(6).uniform(-0.9, 0.9, (200, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    geo, normals, _ = jnet.geometry_with_normals(jp, jcfg, jnp.asarray(xyz))
    tgeo, tn, _ = net.geometry_with_normals(torch.from_numpy(xyz), create_graph=False)
    for k in ("sdf", "geo_feat"):
        np.testing.assert_allclose(tgeo[k].detach().numpy(), np.asarray(geo[k]),
                                   rtol=0, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(normals), rtol=0, atol=1e-4)

    def jloss(p):
        _, _, g = jnet.geometry_with_normals(p, jcfg, jnp.asarray(xyz))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    ref = jax.tree.map(np.asarray, jax.grad(jloss)(jp))
    _, _, g = net.geometry_with_normals(torch.from_numpy(xyz), create_graph=True)
    ((g.norm(dim=-1) - 1.0) ** 2).mean().backward()
    ours = export_jax_layout(net, grads=True)
    assert rel_err(ref["encoder"]["embeddings"], ours["encoder"]["embeddings"]) < GRAD2_RTOL
    for a, b in zip(jax.tree.leaves(ref["sdf_net"]), jax.tree.leaves(ours["sdf_net"])):
        assert rel_err(a, b) < GRAD2_RTOL
