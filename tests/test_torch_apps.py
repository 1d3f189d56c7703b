"""The port's applications and the pieces under them against the JAX
package and the reference's goldens, on the CPU:

* ``demo_render.npz`` (the reference's demo notebook) through
  ``apps/demo_render.py`` with the tracked ``assets/demo_nets.npz`` and
  ``assets/env_nets.npz``, at ``tests/test_demo_parity.py``'s tolerances;
* ``unwrap_env.npz`` through ``apps/unwrap.py:unwrap_env`` at
  ``tests/test_sphere_golden.py``'s 3e-4, and the unwrap of the tracked
  sphere pretrain against JAX's ``unwrap_env``;
* env rotation: the colour extras against JAX's
  ``get_color_mlp_extra_params(..., env_rot_radian)``, and the trained CP
  checkpoint's render turned by it against JAX's ``render_image``;
* ``gen_render_path`` and ``compute_visibility`` against JAX's;
* ``write_png`` read back by PIL and by the port's decoder, every colour type;
* the demo and unwrap CLIs on the CPU.
"""

import io
import os

import numpy as np
import pytest
import torch

from envidr_tpu_torch.apps import demo_render, unwrap
from envidr_tpu_torch.data.png import decode, encode, read_png, write_png
from test_torch_goldens import golden_net
from test_torch_helpers import ROOT, f32_cp_encoder, one_torch_thread_fixture, shared_model

one_torch_thread = one_torch_thread_fixture()

GOLD = os.path.join(ROOT, "tests", "golden")
# tests/test_demo_parity.py
KAPPA_RTOL, KAPPA_ATOL = 1e-4, 1e-6
DIFFUSE_ATOL, SPECULAR_ATOL, SPECULAR_MEAN_MAX = 2e-5, 5e-4, 2e-5
UNWRAP_ATOL = 3e-4                   # tests/test_sphere_golden.py
# the port against JAX's unwrap: both in f32 through the same MLPs (the
# unwrap of one surface point); readings 8.9e-8 (the sphere pretrain) and
# 1.5e-7 (the pretrained-MLP mode)
PRETRAIN_UNWRAP_ATOL = 1e-5
PRETRAIN_CKPT = os.path.join(ROOT, "assets", "env_sphere_pretrain_best.ckpt")
SPHERE_INI = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
CP_CKPT = os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt")
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
EXTRAS_ATOL = 1e-5                   # f32 IDE of rotated directions; reading 6.2e-8
ROT = 0.7                            # radians
# the CP checkpoint's rotated render, port against JAX's jitted eval, both
# with the CP encoder in f32 (in bf16 JAX's jit drops roundings the port
# makes, tests/test_torch_cp_ckpt.py): readings over the 2500 pixels, max
# 2.0e-4 (one pixel at a march boundary), mean 1.1e-7
ROT_PIXEL_ATOL, ROT_PIXEL_MEAN = 1e-3, 1e-5


@pytest.fixture(scope="module")
def demo_fix():
    return np.load(os.path.join(GOLD, "demo_render.npz"))


@pytest.mark.parametrize("case", [0, 1])
def test_demo_render_matches_the_reference_golden(demo_fix, case):
    fix = demo_fix
    m = fix[f"case{case}_material"]
    nets, xyz = demo_render.load_demo_nets(int(m[5]), device="cpu")
    np.testing.assert_array_equal(xyz.numpy(), fix["xyz_encoding"].astype(np.float32))
    mask = fix["mask"]
    rays_o, rays_d = torch.from_numpy(fix["rays_o"][mask]), torch.from_numpy(fix["rays_d"][mask])
    xyzs = rays_o + rays_d * torch.from_numpy(fix["nears"][mask])
    with torch.no_grad():
        kappa_inv, diffuse, specular = demo_render.shade(
            nets, xyz, torch.as_tensor(m[:5], dtype=torch.float32), rays_d, xyzs)
    np.testing.assert_allclose(float(kappa_inv), fix[f"case{case}_kappa_inv"],
                               rtol=KAPPA_RTOL, atol=KAPPA_ATOL)
    np.testing.assert_allclose(diffuse.numpy(), fix[f"case{case}_diffuse"], atol=DIFFUSE_ATOL)
    np.testing.assert_allclose(specular.numpy(), fix[f"case{case}_specular"], atol=SPECULAR_ATOL)
    assert np.abs(specular.numpy() - fix[f"case{case}_specular"]).mean() < SPECULAR_MEAN_MAX


def test_demo_render_cli_writes_the_sphere(tmp_path):
    out = str(tmp_path / "demo.png")
    img = demo_render.main(["--size", "48", "--out", out, "--device", "cpu"])
    back = read_png(out)
    assert back.shape == (48, 48, 3)
    np.testing.assert_array_equal(back, np.round(img * 255).astype(np.uint8))
    fg = back.min(-1) < 255
    assert 0.3 < fg.mean() < 0.7                         # the sphere and the white ground


@pytest.mark.parametrize("env", [2, 7])
def test_unwrap_matches_the_reference_golden(env):
    fix = np.load(os.path.join(GOLD, "unwrap_env.npz"))
    m = fix["material"]
    material = {"roughness": float(m[0]), "metallic": float(m[1]), "color": np.asarray(m[2:5])}
    img = unwrap.unwrap_env(golden_net(fix), env_h=int(fix["env_h"]), env_w=int(fix["env_w"]),
                            radius=0.95, material=material, env_index=(2, 7).index(env))
    np.testing.assert_allclose(img, fix[f"env{env}_image"], atol=UNWRAP_ATOL)


def test_unwrap_of_the_sphere_pretrain_matches_jax(tmp_path):
    """``env_sphere_pretrain_best.ckpt`` (EMA), env 3, at 32x64, and the
    ``--config`` CLI's PNG of it."""
    import pickle

    import jax
    import jax.numpy as jnp
    from envidr_tpu.apps.unwrap import unwrap_env as jax_unwrap
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg

    out = str(tmp_path / "env3.png")
    img = unwrap.main(["--config", SPHERE_INI, "--ckpt", PRETRAIN_CKPT, "--env-index", "3",
                       "--size", "32", "64", "--out", out, "--device", "cpu"])
    opt = jax_load(SPHERE_INI)
    with open(PRETRAIN_CKPT, "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f)["ema"])
    material = {"roughness": 0.7, "metallic": 0.9, "color": jnp.asarray([0.7, 0.7, 0.7, 1.0])}
    ref = jax_unwrap(params, jax_netcfg(opt), env_h=32, env_w=64, material=material,
                     unwrap_roughness=0.7, radius=opt.env_sph_radius, env_index=3)
    np.testing.assert_allclose(img, ref, atol=PRETRAIN_UNWRAP_ATOL)
    np.testing.assert_array_equal(read_png(out), unwrap.to_srgb8(img))
    assert img.std() > 0.01


def test_unwrap_pretrained_mlp_mode_matches_jax():
    """The mode without ``--config``: the tracked rendering MLPs, the
    demo's SDF net and surface encoding, env net 3, through JAX's
    ``unwrap_env`` with the same parameters."""
    import jax.numpy as jnp
    from envidr_tpu.apps.unwrap import unwrap_env as jax_unwrap
    from envidr_tpu.models.network import NetworkConfig as JaxCfg

    net, xyz = unwrap.pretrained_net(env_index=3, device="cpu")
    material = {"roughness": 0.7, "metallic": 0.9, "color": [0.7, 0.7, 0.7, 1.0]}
    img = unwrap.unwrap_env(net, env_h=16, env_w=32, material=material, unwrap_roughness=0.7,
                            xyz_encoding=xyz)
    cfg = JaxCfg(**unwrap.PRETRAINED_CFG)
    params = {}                      # the MLPs the unwrap reads (no encoder)
    for name, layers in net.named_children():
        if name in ("sdf_net", "diffuse_net", "color_net", "renv_net", "env_net"):
            params[name] = [{"w": jnp.asarray(l.weight.detach().numpy().T),
                             "b": jnp.asarray(l.bias.detach().numpy())} for l in layers]
    params["xyz_encoding"] = jnp.asarray(xyz.numpy())
    ref = jax_unwrap(params, cfg, env_h=16, env_w=32, radius=0.95, unwrap_roughness=0.7,
                     material={**material, "color": jnp.asarray(material["color"])})
    np.testing.assert_allclose(img, ref, atol=PRETRAIN_UNWRAP_ATOL)


def test_env_rotation_in_the_colour_extras_matches_jax():
    import jax.numpy as jnp
    from envidr_tpu.models.network import get_color_mlp_extra_params as jax_extras

    (_, jcfg, params), (_, _, net) = shared_model(0)
    rng = np.random.default_rng(0)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rough = rng.uniform(0.05, 0.5, (64, 1)).astype(np.float32)
    ours = net.get_color_mlp_extra_params(torch.from_numpy(n), torch.from_numpy(d),
                                          torch.from_numpy(rough), ROT)
    plain = net.get_color_mlp_extra_params(torch.from_numpy(n), torch.from_numpy(d),
                                           torch.from_numpy(rough))
    ref = jax_extras(params, jcfg, jnp.asarray(n), jnp.asarray(d), jnp.asarray(rough),
                     jnp.asarray(ROT, jnp.float32))
    for name, a, b, c in zip(("normals_enc", "w_r_enc", "n_dot_w_o", "n_env_enc"),
                             ours, ref, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=EXTRAS_ATOL, err_msg=name)
    # the rotation moves the reflected and the diffuse encodings only
    assert np.abs(ours[1].numpy() - plain[1].numpy()).max() > 0.05
    assert np.abs(ours[3].numpy() - plain[3].numpy()).max() > 0.05
    np.testing.assert_array_equal(ours[0].numpy(), plain[0].numpy())


def test_rotated_render_of_the_cp_checkpoint_matches_jax(tmp_path):
    """Val view 0 at downscale 8 (50x50), the environment turned by ROT,
    the port's ``render_image`` against JAX's, from the same checkpoint,
    the CP encoder in f32 in both."""
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.data.synth_scene import SynthSpheres
    from envidr_tpu_torch.train.trainer import Trainer

    small = dict(eval_ray_chunk=512, eval_samples_budget=128)
    with f32_cp_encoder():
        opt = load_options(CP_INI, **small)
        tr = Trainer(opt, network_config(opt), device="cpu")
        assert tr.load_checkpoint(CP_CKPT)
        val = SynthSpheres("val", scale=opt.scale, downscale=8)
        args = (val.poses[0], val.intrinsics, val.H, val.W)
        ours = tr.render_image(*args, use_ema=False, env_rot_radian=ROT)["image"]
        plain = tr.render_image(*args, use_ema=False)["image"]
        jopt = jax_load(CP_INI, workspace=str(tmp_path), **small)
        jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
        assert jt.load_checkpoint(CP_CKPT)
        ref = jt.render_image(*args, use_ema=False, env_rot_radian=ROT)["image"]
    err = np.abs(ours - ref)
    assert err.max() <= ROT_PIXEL_ATOL and err.mean() <= ROT_PIXEL_MEAN, (err.max(), err.mean())
    assert np.abs(ours - plain).max() > 0.02           # the specular term moved


def test_gen_render_path_matches_jax():
    from envidr_tpu.geometry.lighting import gen_render_path as jax_path
    from envidr_tpu_torch.geometry.lighting import gen_render_path
    from envidr_tpu_torch.geometry.rays import pose_spherical

    keys = np.stack([pose_spherical(t, -30.0 + t / 10, 4.0) for t in (0.0, 90.0, 200.0, 300.0)])
    ours = gen_render_path(keys.copy(), 17)
    np.testing.assert_array_equal(ours, jax_path(keys.copy(), 17))
    rot = ours[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-12)


@pytest.mark.parametrize("soft_vis,dot_bias", [(True, False), (False, False), (True, True)])
def test_compute_visibility_matches_jax(soft_vis, dot_bias):
    import jax.numpy as jnp
    from envidr_tpu.geometry.lighting import compute_visibility as jax_vis
    from envidr_tpu_torch.geometry.lighting import compute_visibility

    rng = np.random.default_rng(1)
    P, H, W = 200, 24, 32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    cam_rot = np.eye(3, dtype=np.float32)
    th = 0.3
    light_rot = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0], [np.sin(th), 0, np.cos(th)]],
                         np.float32)
    inputs = dict(
        cam_depth=rng.uniform(2.0, 3.0, P).astype(np.float32),
        light_depth=rng.uniform(2.0, 3.2, (H, W)).astype(np.float32),
        uv=np.stack([rng.uniform(0, W, P), rng.uniform(0, H, P)], -1).astype(np.float32),
        cam_K=K, light_K=K, camrotc2w=cam_rot, cam_pos=np.zeros(3, np.float32),
        lightrotw2c=light_rot, light_pos=np.array([0.5, 0.1, -0.2], np.float32),
        normals=rng.normal(size=(P, 3)).astype(np.float32))
    kw = dict(depth_thres=0.05, soft_vis=soft_vis, dot_bias=dot_bias)
    ours = compute_visibility(**{k: torch.from_numpy(v) for k, v in inputs.items()}, **kw)
    ref = jax_vis(**{k: jnp.asarray(v) for k, v in inputs.items()}, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    assert 0.0 < float(ours.mean()) < 1.0                # both lit and shadowed pixels


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 1), (9, 13, 2), (9, 13, 3), (9, 13, 4)])
def test_write_png_reads_back_in_pil_and_the_decoder(tmp_path, shape):
    from PIL import Image
    img = np.random.default_rng(len(shape) + shape[-1]).integers(0, 256, shape, dtype=np.uint8)
    want = img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img
    path = write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(decode(encode(img)), want)
    with pytest.raises(ValueError):
        encode(img.astype(np.float32))


def test_model_pth_export_matches_jax_and_reads_back(tmp_path):
    """``io/torch_export.py``: the state dict of a network's pytree equals
    the JAX package's export of the same pytree, key for key, and the port's
    importer reads the file back."""
    from envidr_tpu.io.torch_export import network_state_dict as jax_state_dict
    from envidr_tpu_torch.io import torch_export, torch_import
    from envidr_tpu_torch.io.jax_params import network_tree

    (_, _, params), (_, _, net) = shared_model(1)
    tree = network_tree(net)
    ours, ref = torch_export.network_state_dict(tree), jax_state_dict(params)
    assert list(ours) == list(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)
    path = torch_export.save_model_pth(tree, str(tmp_path / "model.pth"), {"epoch": 3})
    back = torch_import.network_params_from_state(torch_import.load_state_dict(path))
    for name in ("sdf_net", "color_net", "env_net"):
        for got, want in zip(back[name], tree[name]):
            np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(back["encoder"]["embeddings"], tree["encoder"]["embeddings"])
