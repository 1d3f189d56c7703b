"""The port's CP encoder (envidr_tpu_torch/ops/cp.py) against the JAX
package's (envidr_tpu/ops/cp.py): forward, first and second order, both
formulations and both compute dtypes, on the same seeded numpy inputs.

Trap C3: the JAX package's default, ``twohot`` in bf16, rounds its weights,
its table and the transposes autodiff takes of the two-hot matmul to bf16
(``jax.make_jaxpr(jax.grad(...))`` shows bf16 ``convert_element_type``s
after each transposed ``dot_general`` and a bf16 ``add_any`` of the two
weights' gradients).  The port matches those roundings with ``.to(bf16)`` in
its graph, so the forward agrees to f32 rounding and the first order to one
flipped bf16 rounding; the second
order rounds the table gradient's partial sums in more places in JAX than in
the port, and that is held to a bound read from a measurement (below)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.ops import cp as jcp
from envidr_tpu_torch.ops import cp as tcp
from test_torch_helpers import rel_err

SMALL = dict(num_levels=4, level_dim=2, rank=8, base_resolution=4, desired_resolution=32)
N = 512
FWD_RTOL = 1e-6       # of the max: the same f32 products, another matmul order
GRAD1_RTOL = 1e-5     # of the max, f32: f32 sums over points in another order
GRAD2_RTOL = 1.3e-3   # of the max, f32 double backward (ROADMAP C-5)
# bf16, first order: the port rounds where JAX rounds; only the f32 sum before
# a rounding differs in order, which can move one rounded value by one bf16
# ulp, 2^-8 of it.  Readings (tests/cp_readings.py), seeds 1-3: 2.5e-8,
# 4.6e-5, 0.
BF16_GRAD1_RTOL = 2.0**-8
# bf16, second order (the eikonal's mixed d2/dT dx term): JAX rounds each
# partial table gradient to bf16 and adds them in bf16, the port sums them in
# f32 and rounds once.  Readings (tests/cp_readings.py), tables, seeds 1-3:
# port against JAX bf16 7.4e-3, 7.0e-3, 7.6e-3; JAX bf16 against JAX f32 (the
# rounding's own size) 1.1e-2, 1.3e-2, 8.3e-3.  So 2^-6 (4 bf16 ulps of the
# max) leaves 2x room.
BF16_GRAD2_RTOL = 2.0**-6

VARIANTS = [("float32", "twohot"), ("float32", "take"), ("bfloat16", "twohot"),
            ("bfloat16", "take")]


def _case(dtype, form, seed=1):
    js = jcp.CPSpec(**SMALL, compute_dtype=dtype, formulation=form)
    ts = tcp.CPSpec(**SMALL, compute_dtype=dtype, formulation=form)
    params = jax.tree.map(np.asarray, jcp.init_cp_params(jax.random.PRNGKey(0), js))
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    return js, ts, params, x, rng


def _torch_params(params):
    return {"axes": [[torch.tensor(a, requires_grad=True) for a in lvl]
                     for lvl in params["axes"]],
            "proj": [torch.tensor(a, requires_grad=True) for a in params["proj"]]}


def _leaves(p):
    return [*[a for lvl in p["axes"] for a in lvl], *p["proj"]]


def test_spec_matches():
    for kw in (SMALL, {}):
        js, ts = jcp.CPSpec(**kw), tcp.CPSpec(**kw)
        assert js.resolutions == ts.resolutions and js.scales == ts.scales
        assert (ts.compute_dtype, ts.formulation) == ("bfloat16", "twohot")


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_forward_matches(dtype, form):
    js, ts, params, x, _ = _case(dtype, form)
    ref = np.asarray(jcp.cp_encode(jnp.asarray(x), jax.tree.map(jnp.asarray, params), js))
    with torch.no_grad():
        ours = tcp.cp_encode(torch.from_numpy(x), _torch_params(params), ts).numpy()
    assert rel_err(ref, ours) <= FWD_RTOL


def test_out_of_bounds_rows_are_zero():
    js, ts, params, x, _ = _case("bfloat16", "twohot")
    x[:4] = [[1.5, 0.5, 0.5], [0.5, -0.1, 0.5], [0.2, 0.3, 1.0001], [-2.0, 3.0, 0.5]]
    with torch.no_grad():
        ours = tcp.cp_encode(torch.from_numpy(x), _torch_params(params), ts).numpy()
    assert (ours[:4] == 0).all() and (np.abs(ours[4:]).max(axis=-1) > 0).all()
    ref = np.asarray(jcp.cp_encode(jnp.asarray(x), jax.tree.map(jnp.asarray, params), js))
    assert (ref[:4] == 0).all()


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_first_order_gradients_match(dtype, form):
    js, ts, params, x, rng = _case(dtype, form)
    cot = rng.standard_normal((N, js.output_dim)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jcp.cp_encode(xx, p, js) * cot)

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                  jnp.asarray(x))
    tp = _torch_params(params)
    tx = torch.tensor(x, requires_grad=True)
    grads = torch.autograd.grad((tcp.cp_encode(tx, tp, ts) * torch.from_numpy(cot)).sum(),
                                [*_leaves(tp), tx])
    tol = BF16_GRAD1_RTOL if ts.rounds_bf16 else GRAD1_RTOL
    for ref, ours in zip([*_leaves(jg_p), jg_x], grads):
        assert rel_err(ref, ours) <= tol


@pytest.mark.parametrize("dtype,form", VARIANTS)
def test_second_order_mixed_term_matches(dtype, form):
    """The eikonal pattern: grad of a loss of d(encoding . w)/dx with respect
    to the tables, the projections and x (tests/test_cp.py:43)."""
    js, ts, params, x, rng = _case(dtype, form)
    w = rng.standard_normal((js.output_dim,)).astype(np.float32)

    def eik(p, xx):
        gx = jax.grad(lambda y: jnp.sum(jcp.cp_encode(y, p, js) @ w))(xx)
        return jnp.sum((jnp.linalg.norm(gx, axis=-1) - 1.0) ** 2)

    jg_p, jg_x = jax.grad(eik, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                 jnp.asarray(x))
    tp = _torch_params(params)
    tx = torch.tensor(x, requires_grad=True)
    f = (tcp.cp_encode(tx, tp, ts) @ torch.from_numpy(w)).sum()
    (gx,) = torch.autograd.grad(f, tx, create_graph=True)
    grads = torch.autograd.grad(((gx.norm(dim=-1) - 1.0) ** 2).sum(), [*_leaves(tp), tx])
    tol = BF16_GRAD2_RTOL if ts.rounds_bf16 else GRAD2_RTOL
    errs = [rel_err(ref, ours) for ref, ours in zip([*_leaves(jg_p), jg_x], grads)]
    assert max(errs) <= tol, errs
    assert all(float(g.abs().sum()) > 0 for g in grads)
