"""The port's network (models/network.py) and its small ops against the JAX
package, with shared parameters.  The hash config computes in float32 on
both sides (its MLPs have no bf16 path; ROADMAP C-1 concerns the CP encoder)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.models import network as jnet
from envidr_tpu.ops import density as jdens, freq as jfreq, ide as jide, sh as jsh
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops import density as tdens, freq as tfreq, ide as tide, sh as tsh
from test_torch_helpers import export_jax_layout, rel_err, shared_model

FWD_ATOL = 2e-5     # f32 through a 3-layer width-16 MLP
GRAD_RTOL = 1.3e-3  # double backward, rel. to max (ROADMAP C-3)


def _dirs(n, seed=0):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    v[0] = [0.0, 0.0, 1.0]                         # the x = y = 0 quirk of IDE
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_ide_matches(deg):
    d = _dirs(200)
    r = np.random.default_rng(1).uniform(0, 1, (200, 1)).astype(np.float32)
    ref = np.asarray(jide.ide_encode(jnp.asarray(d), jnp.asarray(r), deg_view=deg))
    ours = tide.ide_encode(torch.from_numpy(d), torch.from_numpy(r), deg_view=deg).numpy()
    # degree 5 sums z^k up to k = 16 with coefficients of order 10^3 (and
    # cancellation), so f32 order-of-summation error grows to ~2e-4
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 if deg <= 4 else 5e-4)


def test_ide_gradient_is_finite_at_poles():
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], requires_grad=True)
    tide.ide_encode(d, 0.1, deg_view=4).sum().backward()
    assert torch.isfinite(d.grad).all()


@pytest.mark.parametrize("deg", [1, 2, 4, 8])
def test_sh_matches(deg):
    d = _dirs(100, seed=2)
    ref = np.asarray(jsh.sh_encode(jnp.asarray(d), degree=deg))
    np.testing.assert_allclose(tsh.sh_encode(torch.from_numpy(d), degree=deg).numpy(),
                               ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("degree", [0, 4])
def test_freq_matches(degree):
    x = np.random.default_rng(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    ref = np.asarray(jfreq.freq_encode(jnp.asarray(x), degree=degree))
    np.testing.assert_allclose(tfreq.freq_encode(torch.from_numpy(x), degree=degree).numpy(),
                               ref, rtol=0, atol=1e-5)


def test_density_ops_match():
    sdf = np.linspace(-0.5, 0.5, 101).astype(np.float32)
    beta = np.float32(0.07)
    ref = np.asarray(jdens.laplace_density(jnp.asarray(sdf), jnp.asarray(beta)))
    ours = tdens.laplace_density(torch.from_numpy(sdf), torch.tensor(beta)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    b = torch.tensor(5e-5, requires_grad=True)
    clamped = tdens.laplace_beta(b, 1e-4, 1.0)
    clamped.backward()
    assert float(clamped.detach()) == pytest.approx(1e-4) and float(b.grad) == 1.0
    x = torch.tensor([-20.0, 0.0, 20.0], requires_grad=True)
    tdens.trunc_exp(x).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jdens.trunc_exp(v)))(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_param_bridge_round_trip():
    (_, _, params), (_, _, net) = shared_model(seed=5)
    back = export_jax_layout(net)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_param_bridge_rejects_mismatch():
    (_, _, params), (_, tcfg, _) = shared_model(seed=5)
    params["color_net"][0]["w"] = params["color_net"][0]["w"][:-1]
    with pytest.raises(ValueError):
        load_jax_params(NeRFNetwork(tcfg), params)


def _geometry_case(seed=0, n=200):
    (jopt, jcfg, params), (topt, tcfg, net) = shared_model(seed=seed)
    xyz = np.random.default_rng(seed + 10).uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    return jcfg, params, net, xyz


def test_geometry_with_normals_matches():
    jcfg, params, net, xyz = _geometry_case()
    jp = jax.tree.map(jnp.asarray, params)
    geo, normals, grads = jnet.geometry_with_normals(jp, jcfg, jnp.asarray(xyz))
    tgeo, tn, tg = net.geometry_with_normals(torch.from_numpy(xyz), create_graph=False)
    for k in ("sdf", "geo_feat", "roughness"):
        np.testing.assert_allclose(tgeo[k].detach().numpy(), np.asarray(geo[k]),
                                   rtol=0, atol=FWD_ATOL, err_msg=k)
    assert rel_err(np.asarray(grads), tg.detach().numpy()) < 1e-4
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(normals), rtol=0, atol=1e-4)


def test_eikonal_gradients_through_network_match():
    """d/dparams of mean((|d sdf/dx| - 1)^2): the double backward of the MLP
    and of the hash encoder."""
    jcfg, params, net, xyz = _geometry_case(seed=1)
    jp = jax.tree.map(jnp.asarray, params)

    def jloss(p):
        _, _, g = jnet.geometry_with_normals(p, jcfg, jnp.asarray(xyz))
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    ref = jax.tree.map(np.asarray, jax.grad(jloss)(jp))
    _, _, g = net.geometry_with_normals(torch.from_numpy(xyz), create_graph=True)
    ((g.norm(dim=-1) - 1.0) ** 2).mean().backward()
    ours = export_jax_layout(net, grads=True)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref["sdf_net"]),
                                 jax.tree_util.tree_leaves_with_path(ours["sdf_net"])):
        assert rel_err(a, b) < GRAD_RTOL, path
    assert rel_err(ref["encoder"]["embeddings"], ours["encoder"]["embeddings"]) < GRAD_RTOL


def test_forward_color_matches():
    jcfg, params, net, xyz = _geometry_case(seed=2, n=150)
    jp = jax.tree.map(jnp.asarray, params)
    dirs = _dirs(150, seed=3)
    geo, normals, _ = jnet.geometry_with_normals(jp, jcfg, jnp.asarray(xyz))
    extra = jnet.get_color_mlp_extra_params(jp, jcfg, normals, jnp.asarray(dirs),
                                            geo["roughness"])
    ref, raux = jnet.forward_color(jp, jcfg, geo["geo_feat"], jnp.asarray(dirs), *extra[:3],
                                   n_env_enc=extra[3], roughness=geo["roughness"])

    tgeo, tn, _ = net.geometry_with_normals(torch.from_numpy(xyz), create_graph=False)
    textra = net.get_color_mlp_extra_params(tn, torch.from_numpy(dirs), tgeo["roughness"])
    for a, b in zip(extra, textra):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=0, atol=1e-4)
    ours, taux = net.forward_color(tgeo["geo_feat"], torch.from_numpy(dirs), *textra[:3],
                                   n_env_enc=textra[3])
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    for k in ("c_diffuse", "c_specular"):
        np.testing.assert_allclose(taux[k].detach().numpy(), np.asarray(raux[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_unported_options_raise():
    """``skip_layers`` is the one network option the port refuses: the JAX
    package's own SDF net fails on it
    (``tests/test_torch_runtime_options.py::test_jax_fails_on_skip_layers``)."""
    (_, _, _), (_, tcfg, _) = shared_model()
    import dataclasses
    with pytest.raises(NotImplementedError, match="skip_layers .*network.py:254-263"):
        NeRFNetwork(dataclasses.replace(tcfg, skip_layers=(1,)))
