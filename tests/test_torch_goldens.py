"""The port against the reference's own goldens (``tests/golden/*.npz``,
frozen from the reference's torch pipeline by ``tools/gen_golden.py``), at
the JAX tests' tolerances:

* ``sphere_render.npz``: the sphere render (``sph_ray.py:34-221``) of a
  frequency-encoded SDF net with the reference's pretrained rendering MLPs
  and env nets 2 and 7, in two materials (``tests/test_sphere_golden.py``);
* ``sphere_grads.npz``: the gradients of a sphere shade with the eikonal
  term's double backward (``tests/test_grad_parity.py``);
* ``volume_grads.npz``: one volume-render step through the ``hash`` encoder
  (smoothstep), the SDF MLP, autograd normals, the straight-through Laplace
  beta, compositing, mse + eikonal; through both indexings, as the JAX
  test runs it;
* ``ide.npz``: the integrated directional encoding (``tests/test_encoders.py``).

The JAX tests of the first two read their weights from a reference mount;
the same weights are tracked as ``assets/rendering_mlps.npz`` and
``assets/env_nets.npz``, which these tests read through the port's readers
(``io/torch_import.py``)."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.io.torch_import import load_npz_env_nets, load_npz_mlps
from envidr_tpu_torch.models.network import NeRFNetwork, NetworkConfig
from envidr_tpu_torch.ops.hashgrid import HashGridSpec, hash_encode
from envidr_tpu_torch.ops.ide import ide_encode, ide_output_dim
from envidr_tpu_torch.render.sphere import SphereRenderOptions, render_sphere
from test_torch_helpers import ROOT, export_jax_layout

GOLD = os.path.join(ROOT, "tests", "golden")
# configs/neural_renderer.ini with the fixture's frequency geometry
# (tests/test_sphere_golden.py's CFG)
CFG = NetworkConfig(
    encoding_pos="frequency", multires=6, env_sph_mode=True, num_env_nets=2,
    in_roughness=1, in_metallic=1, in_base_color=3, num_layers=3, geo_feat_dim=12,
    env_feat_dim=12, hidden_dim_env=160, roughness_act_scale=1.0,
    geo_feat_act="unitNorm", env_feat_act="unitNorm", init_beta=0.1, sh_degree=4)
GOLDEN_ENVS = (2, 7)
IMAGE_ATOL = 2e-4          # tests/test_sphere_golden.py
NORMAL_ATOL = 1e-2         # on solid pixels (weights_sum > 0.05)
GRAD_REL_TO_MAX = 3e-3     # tests/test_grad_parity.py: torch's own f32 double
                           # backward is 1.3e-3 of the max from an f64 oracle


@torch.no_grad()
def golden_net(fix) -> NeRFNetwork:
    """CFG with the fixture's SDF net ([out, in], the torch layout), the
    reference's diffuse and colour nets and env nets 2 and 7, read from the
    tracked ``.npz`` files by the port's readers."""
    net = NeRFNetwork(CFG, generator=torch.Generator().manual_seed(0))
    params = export_jax_layout(net)
    params["sdf_net"] = [{"w": fix[f"sdf_net.{i}.w"].T, "b": fix[f"sdf_net.{i}.b"]}
                         for i in range(3)]
    params.update(load_npz_mlps(os.path.join(ROOT, "assets", "rendering_mlps.npz"),
                                ("diffuse_net", "color_net")))
    params["env_nets"] = load_npz_env_nets(os.path.join(ROOT, "assets", "env_nets.npz"),
                                           GOLDEN_ENVS)
    return load_jax_params(net, params)


def _material(m):
    return {"roughness": float(m[0]), "metallic": float(m[1]), "color": np.asarray(m[2:5])}


@pytest.fixture(scope="module")
def sphere_fix():
    return np.load(os.path.join(GOLD, "sphere_render.npz"))


@pytest.mark.parametrize("case", [0, 1])
def test_render_sphere_matches_the_reference_golden(sphere_fix, case):
    fix = sphere_fix
    net = golden_net(fix)
    opts = SphereRenderOptions(num_step=12, step_size=0.002, radius=0.95, training=False)
    m = fix[f"case{case}_material"]
    with torch.no_grad():
        res = render_sphere(net, opts, torch.from_numpy(fix["rays_o"]),
                            torch.from_numpy(fix["rays_d"]), 1.0, material=_material(m),
                            env_index=int(m[5]))
    for key in ("image", "depth", "weights_sum", "diffuse_image", "specular_image",
                "roughness_image"):
        np.testing.assert_allclose(res[key].numpy(), fix[f"case{case}_{key}"], atol=IMAGE_ATOL,
                                   err_msg=f"case{case} {key}")
    solid = fix[f"case{case}_weights_sum"] > 0.05
    np.testing.assert_allclose(res["normal_image"].numpy()[solid],
                               fix[f"case{case}_normal_image"][solid], atol=NORMAL_ATOL)
    assert bool(fix["mask"].any()) and not bool(fix["mask"].all())
    np.testing.assert_array_equal(res["mask"].numpy(), fix["mask"])


def _grad_close(ours, ref, name, rtol=0.0, rel_to_max=GRAD_REL_TO_MAX):
    """tests/test_grad_parity.py's ``_allclose``: atol is ``rel_to_max`` of
    the reference's max |grad| (plus 1e-6)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=rtol,
                               atol=1e-6 + rel_to_max * np.abs(ref).max(),
                               err_msg=f"gradient mismatch: {name}")


def test_sphere_shade_gradients_match_the_reference_golden():
    fix = np.load(os.path.join(GOLD, "sphere_grads.npz"))
    net = golden_net(fix)
    opts = SphereRenderOptions(num_step=12, step_size=0.002, radius=0.95, training=True)
    out = render_sphere(net, opts, torch.from_numpy(fix["rays_o"]),
                        torch.from_numpy(fix["rays_d"]), 1.0,
                        material=_material(fix["material"]), env_index=0)
    eik = ((torch.linalg.vector_norm(out["sdf_gradients"], dim=-1) - 1.0) ** 2).mean()
    loss = (out["image"] * torch.from_numpy(fix["w_fix"])).sum() + 0.05 * eik
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fix["loss"]), rtol=1e-4)
    for name in ("sdf_net", "diffuse_net", "color_net"):
        for i, layer in enumerate(getattr(net, name)):
            _grad_close(layer.weight.grad, fix[f"grad.{name}.{i}.w"], f"{name}.{i}.w")
            _grad_close(layer.bias.grad, fix[f"grad.{name}.{i}.b"], f"{name}.{i}.b")
    # the stack's env 0 takes the reference's gradient, env 1 exactly zero
    for i, layer in enumerate(net.env_nets):
        _grad_close(layer.weight.grad[0], fix[f"grad.env_net.{i}.w"], f"env_net.{i}.w")
        _grad_close(layer.bias.grad[0], fix[f"grad.env_net.{i}.b"], f"env_net.{i}.b")
        assert float(layer.weight.grad[1].abs().max()) == 0.0


def _volume_loss(fix, spec, p):
    """tests/test_grad_parity.py's ``_volume_loss_fn`` in torch."""
    rays_o, rays_d, z_vals, target = (torch.from_numpy(fix[k]) for k in
                                      ("rays_o", "rays_d", "z_vals", "target"))
    xyz = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None], -0.8, 0.8)
    dirs = rays_d[:, None, :].expand_as(xyz)

    def mlp(name, h):
        for l in range(2):
            h = h @ p[f"{name}.{l}.w"].T + p[f"{name}.{l}.b"]
            if l != 1:
                h = F.relu(h)
        return h

    def geometry(x):
        feats = hash_encode((x + 1.0) / 2.0, p["embeddings"], spec)
        h = mlp("mlp1", torch.cat([feats, x], -1))
        return h[..., 0], h[..., 1:9]

    x = xyz.detach().requires_grad_(True)
    sdf, geo_feat = geometry(x)
    (raw_grad,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    normals = raw_grad / torch.linalg.vector_norm(raw_grad, dim=-1, keepdim=True).clamp_min(1e-10)
    beta = p["beta"]
    beta_eff = beta + (torch.clamp(beta.detach(), 1e-4, 1.0) - beta.detach())
    sigmas = (1.0 / beta_eff) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() / beta_eff))
    rgbs = torch.sigmoid(mlp("mlp2", torch.cat([geo_feat, normals, dirs], -1)))
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 0.07)], -1)
    alphas = 1.0 - torch.exp(-deltas * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-15], -1)
    weights = alphas * torch.cumprod(shifted, -1)[..., :-1]
    wsum = weights.sum(-1, keepdim=True)
    image = (weights[..., None] * rgbs).sum(-2) + (1.0 - wsum)
    eik = ((torch.linalg.vector_norm(raw_grad, dim=-1) - 1.0) ** 2).mean()
    return ((image - target) ** 2).mean() + 0.01 * eik


@pytest.mark.parametrize("indexing", ["hash", "rolled_tiled"])
def test_volume_step_gradients_match_the_reference_golden(indexing):
    fix = np.load(os.path.join(GOLD, "volume_grads.npz"))
    L, C, base, desired, log2_hm = (int(v) for v in fix["spec"])
    spec = HashGridSpec(num_levels=L, level_dim=C, base_resolution=base,
                        desired_resolution=desired, log2_hashmap_size=log2_hm,
                        interpolation="smoothstep", indexing=indexing,
                        custom_grad=indexing == "rolled_tiled")
    p = {"embeddings": torch.tensor(fix["embeddings"], requires_grad=True),
         "beta": torch.tensor(fix["beta"], requires_grad=True)}
    for name in ("mlp1", "mlp2"):
        for l in range(2):
            for k in ("w", "b"):
                p[f"{name}.{l}.{k}"] = torch.tensor(fix[f"{name}.{l}.{k}"], requires_grad=True)
    loss = _volume_loss(fix, spec, p)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fix["loss"]), rtol=1e-5)
    _grad_close(p["embeddings"].grad, fix["grad_embeddings"], f"embeddings[{indexing}]",
                rtol=1e-3, rel_to_max=1e-5)
    _grad_close(p["beta"].grad, fix["grad_beta"], "beta", rtol=5e-4, rel_to_max=1e-5)
    for name in ("mlp1", "mlp2"):
        for l in range(2):
            for k in ("w", "b"):
                _grad_close(p[f"{name}.{l}.{k}"].grad, fix[f"grad.{name}.{l}.{k}"],
                            f"{name}.{l}.{k}", rtol=5e-4, rel_to_max=1e-5)


@pytest.fixture(scope="module")
def ide_fix():
    return np.load(os.path.join(GOLD, "ide.npz"))


def _ide_atol(deg):
    # deg 5's l=16 band cancels in f32 (tests/test_encoders.py)
    return 2e-5 if deg < 5 else 3e-4


@pytest.mark.parametrize("deg", [2, 3, 4, 5])
def test_ide_matches_the_reference_golden(ide_fix, deg):
    dirs = torch.from_numpy(ide_fix["dirs"])
    got = ide_encode(dirs, torch.from_numpy(ide_fix["rough"]), deg_view=deg).numpy()
    assert got.shape == (dirs.shape[0], ide_output_dim(deg))
    for key in (f"deg{deg}", f"deg{deg}_wo_j"):
        np.testing.assert_allclose(got, ide_fix[key], atol=_ide_atol(deg), rtol=1e-4)


@pytest.mark.parametrize("deg", [4, 5])
def test_ide_scalar_roughness_matches_the_reference_golden(ide_fix, deg):
    got = ide_encode(torch.from_numpy(ide_fix["dirs"]), 0.64, deg_view=deg).numpy()
    np.testing.assert_allclose(got, ide_fix[f"deg{deg}_r0.64"], atol=_ide_atol(deg), rtol=1e-4)


def test_state_dict_env_net_stack_reads_as_jax(tmp_path):
    """A full-model state dict with the stack of sphere mode
    (``env_nets.{e}.{layer}.weight``) and a renv net, read by both packages."""
    from envidr_tpu.io.torch_import import network_params_from_state as jax_read
    from envidr_tpu_torch.io.torch_import import load_state_dict, network_params_from_state
    rng = np.random.default_rng(0)
    sd = {f"env_nets.{e}.{l}.{k}": torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for e in range(3) for l, (o, i) in enumerate(((8, 5), (4, 8)))
          for k, s in (("weight", (o, i)), ("bias", (o,)))}
    sd.update({f"renv_net.{l}.weight": torch.ones(4, 4) * l for l in range(2)})
    path = os.path.join(tmp_path, "m.pth")
    torch.save({"model": sd}, path)
    ours = network_params_from_state(load_state_dict(path))
    ref = jax_read(load_state_dict(path), CFG)
    for name in ("env_nets", "renv_net"):
        assert len(ours[name]) == len(ref[name]) == 2
        for a, b in zip(ours[name], ref[name]):
            for k in ("w", "b"):
                if k in b:
                    np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    assert ours["env_nets"][0]["w"].shape == (3, 5, 8)
