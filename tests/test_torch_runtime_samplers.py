"""The march, the ray samplers and ``render_env_on_sphere`` of the scene
runtime in the port against the JAX package:

* the march's growing steps (``dt_gamma > 0``) against the oracle of
  ``tests/test_marching.py`` and JAX's march, its fallback from the coarse
  march, and a continued march (``t_start``) on both paths;
* the patch and centre-crop ray samplers on JAX's draws; image batches: the
  epoch's groups against JAX's epoch, a step's rays and pixels;
* ``render_env_on_sphere``: no grid, one env net, the sphere renders of
  ``configs/neural_renderer_cp.ini`` cut to test size (the CP encoder in
  f32, the JAX side jitted)."""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
from envidr_tpu.ops.marching import march_rays as jax_march
from envidr_tpu.train.trainer import Trainer as JaxTrainer
from envidr_tpu_torch.config import load_options as torch_load, network_config as torch_netcfg
from envidr_tpu_torch.geometry import rays as trays
from envidr_tpu_torch.io.jax_params import load_jax_params
from envidr_tpu_torch.models.network import NeRFNetwork
from envidr_tpu_torch.ops.marching import MARCH_PATHS, march_rays
from envidr_tpu_torch.train.trainer import Trainer
from test_marching import _blob_grid, _random_grid, oracle_march
from test_torch_helpers import (CP_LAPLACE_INI, CP_SMALL, ROOT, f32_cp_encoder,
                                one_torch_thread_fixture)

one_torch_thread = one_torch_thread_fixture()
# the sphere render's reading on the CPU: 1.2e-7 at most; ~8x
IMAGE_ATOL = 1e-6


# ------------------------------------------------------------------ march

def _march_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, -3.0]], (n, 1)).astype(np.float32)
    d = rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 2.0, np.float32), np.full(n, 4.2, np.float32)


def test_dt_gamma_march_matches_the_oracle_and_jax():
    H = 32
    occ3d = _random_grid(seed=3, H=H, p=0.3)
    o, d, near, far = _march_rays(12, seed=4)
    kw = dict(bound=1.0, grid_size=H, dt_gamma=1 / 128, max_steps=512, num_samples=64)
    MARCH_PATHS.clear()
    res = march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
                     torch.from_numpy(far), torch.from_numpy(occ3d.reshape(1, -1)), **kw)
    assert MARCH_PATHS == {"dense": 1}
    ref = jax_march(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near), jnp.asarray(far),
                    jnp.asarray(occ3d.reshape(1, -1)), **kw)
    for n in range(12):
        want = oracle_march(o[n], d[n], near[n], far[n], occ3d, 1.0, 1 / 128, 512, 64)
        assert int(res.counts[n]) == len(want)
        for k, (t_w, dt_w) in enumerate(want):
            np.testing.assert_allclose(float(res.ts[n, k]), t_w, rtol=1e-4)
            np.testing.assert_allclose(float(res.dts[n, k]), dt_w, rtol=1e-4)
    for f in ("ts", "dts", "z_vals", "mask", "counts"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert float(res.dts[res.mask].max()) > float(res.dts[res.mask].min())    # the step grows


def test_dt_gamma_perturbed_march_matches_jax_and_coarse_falls_back(capsys):
    H = 32
    occ3d = _blob_grid(H=H)
    bits = occ3d.reshape(1, -1, order="F")
    o, d, near, far = _march_rays(8, seed=5)
    u = np.random.default_rng(6).uniform(size=8).astype(np.float32)
    kw = dict(bound=1.0, grid_size=H, dt_gamma=1 / 256, max_steps=256, num_samples=32)
    MARCH_PATHS.clear()
    for _ in range(2):
        res = march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
                         torch.from_numpy(far), torch.from_numpy(bits),
                         noise=torch.from_numpy(u), coarse_march=True, **kw)
    assert MARCH_PATHS == {"dense": 2}
    out = capsys.readouterr().out
    assert out.count("falling back to the dense march") <= 1
    with pytest.MonkeyPatch.context() as mp:       # JAX's perturbation draws are u
        mp.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
        ref = jax_march(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near), jnp.asarray(far),
                        jnp.asarray(bits), perturb_key=jax.random.PRNGKey(0), **kw)
    for f in ("ts", "dts", "counts"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("coarse", [False, True], ids=["dense", "coarse"])
def test_t_start_march_matches_jax(coarse):
    """The continued march of ``tests/test_marching.py::test_coarse_march_t_start``
    on each path: it starts at ``t_start``, and ``z_vals`` still count from
    ``nears``."""
    H = 32
    bits = _blob_grid(H=H).reshape(1, -1, order="F")
    o, d, near, far = _march_rays(8, seed=3)
    t_start = near + np.random.default_rng(3).uniform(0.3, 0.6, 8).astype(np.float32)
    kw = dict(bound=1.0, grid_size=H, dt_gamma=0.0, max_steps=256, num_samples=32,
              coarse_march=coarse)
    MARCH_PATHS.clear()
    res = march_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(near),
                     torch.from_numpy(far), torch.from_numpy(bits),
                     t_start=torch.from_numpy(t_start), **kw)
    assert MARCH_PATHS == {"coarse" if coarse else "dense": 1}
    ref = jax_march(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near), jnp.asarray(far),
                    jnp.asarray(bits), t_start=jnp.asarray(t_start), **kw)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(ref.counts))
    for f in ("ts", "z_vals"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    first = res.ts[:, 0][res.mask[:, 0]]
    assert (first >= torch.from_numpy(t_start)[res.mask[:, 0]] - 1e-6).all()


# --------------------------------------------------------------- samplers

POSES = np.stack([np.eye(4, dtype=np.float32)] * 2)
POSES[:, 2, 3] = [2.5, 3.0]
INTR = (20.0, 22.0, 12.0, 10.0)


def _same_rays(ours, ref):
    for k in ("rays_o", "rays_d", "inds"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_patch_rays_match_jax_on_its_draws():
    from envidr_tpu.geometry.rays import patch_rays as jax_patch_rays
    H, W, N, p = 20, 24, 70, 4
    key = jax.random.PRNGKey(7)
    ref = jax_patch_rays(key, jnp.asarray(POSES), INTR, H, W, N, p)
    k1, k2 = jax.random.split(key)
    n = N // (p * p)
    corners = (np.asarray(jax.random.randint(k1, (n,), 0, H - p)),
               np.asarray(jax.random.randint(k2, (n,), 0, W - p)))
    ours = trays.patch_rays(None, torch.from_numpy(POSES), INTR, H, W, N, p, corners=corners)
    _same_rays(ours, ref)
    assert ours["inds"].shape == (2, 64)                     # 70 rays round down to 4 patches
    own = trays.patch_rays(torch.Generator().manual_seed(0), torch.from_numpy(POSES), INTR,
                           H, W, 4096, p)["inds"][0]
    rows, cols = own // W, own % W
    assert int(rows.max()) == H - 2 and int(cols.max()) == W - 2    # randint's bound is exclusive
    blocks = own.reshape(-1, p * p)
    assert (blocks - blocks[:, :1] == torch.from_numpy(
        (np.arange(p)[:, None] * W + np.arange(p)[None]).reshape(-1))).all()


def test_center_crop_rays_match_jax_on_its_draws():
    from envidr_tpu.geometry.rays import center_crop_rays as jax_crop_rays
    H, W, N = 20, 24, 50
    key = jax.random.PRNGKey(8)
    ref = jax_crop_rays(key, jnp.asarray(POSES), INTR, H, W, N, 0.5, 0.6)
    k1, k2, k3 = jax.random.split(key, 3)
    n_crop = int(N * 0.6)
    draws = (np.asarray(jax.random.randint(k1, (n_crop,), 0, H - 2 * 5)),
             np.asarray(jax.random.randint(k2, (n_crop,), 0, W - 2 * 6)),
             np.asarray(jax.random.randint(k3, (N - n_crop,), 0, H * W)))
    ours = trays.center_crop_rays(None, torch.from_numpy(POSES), INTR, H, W, N, 0.5, 0.6,
                                  draws=draws)
    _same_rays(ours, ref)
    own = trays.center_crop_rays(torch.Generator().manual_seed(1), torch.from_numpy(POSES),
                                 INTR, H, W, 2000, 0.5, 0.6)["inds"][0][:1200]
    rows, cols = own // W, own % W
    assert int(rows.min()) == 5 and int(rows.max()) == H - 6
    assert int(cols.min()) == 6 and int(cols.max()) == W - 7


class ImageSet:
    """``n`` random RGBA views, the dataset interface the trainer reads."""

    def __init__(self, n=3, H=6, W=5, C=4, seed=9):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, H, W, C), dtype=np.uint8)
        self.poses = np.stack([np.eye(4, dtype=np.float32)] * n)
        self.poses[:, 2, 3] = 2.5 + 0.1 * np.arange(n)
        self.poses[:, 0, 3] = 0.05 * np.arange(n)
        self.intrinsics, self.H, self.W, self.C = (6.0, 6.0, 2.5, 3.0), H, W, C

    def __len__(self):
        return len(self.images)

    def epoch_order(self, rng):
        return rng.permutation(len(self))

    def device_images(self, device):
        n, H, W, C = self.images.shape
        return torch.from_numpy(self.images.reshape(n, H * W, C)).to(device)


def test_image_batch_epoch_groups_match_jax(tmp_path):
    """Three views in groups of two: JAX's epoch pads the trailing group
    with the order's first view; the port's order holds the same groups.
    The JAX trainer's step is a stand-in, so its parameters are one leaf."""
    kw = {**CP_SMALL, "image_batch": 2}
    jopt = jax_load(CP_LAPLACE_INI, workspace=str(tmp_path), **kw)
    jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path),
                    params={"sdf_density": {"beta": np.float32(0.1)}})
    data = ImageSet()
    seen = []

    def fake_step(state, batch, key, weights):
        seen.append(np.asarray(batch["pose"])[:, 0, 3].copy())
        return state, {"loss": jnp.zeros(()), "mean_count": jnp.ones(())}

    jt._get_train_step = lambda *a, **k: fake_step
    jt.update_extra_state = lambda *a, **k: None
    stub = types.SimpleNamespace(epoch_order=data.epoch_order, intrinsics=data.intrinsics,
                                 device_images=jnp.asarray(data.images.reshape(3, 30, 4)),
                                 device_poses=jnp.asarray(data.poses), H=6, W=5, C=4)
    for _ in range(2):
        jt.train_one_epoch(stub)
    topt = torch_load(CP_LAPLACE_INI, **kw)
    tr = Trainer(topt, torch_netcfg(topt), device="cpu")
    ours = []
    for _ in range(2):
        tr._start_epoch(data)
        ours += [data.poses[list(g), 0, 3] for g in tr._order]
    assert len(seen) == len(ours) == 4
    for a, b in zip(ours, seen):
        np.testing.assert_array_equal(a, b)


def test_image_batch_step_rays_and_pixels_match_jax(monkeypatch):
    """A two-view step: the rays split across the views, each view's rays at
    the same pixels, its pixels gathered from its own image (JAX's
    ``take_along_axis``), then a finite update."""
    from envidr_tpu.geometry.rays import _rays_from_pixels
    import envidr_tpu_torch.train.trainer as ttrainer
    topt = torch_load(CP_LAPLACE_INI, **{**CP_SMALL, "image_batch": 2, "num_rays": 64})
    tr = Trainer(topt, torch_netcfg(topt), device="cpu")
    data = ImageSet()
    seen = {}
    sampled, forward = ttrainer.sampled_rays, tr.forward_loss

    def spy_rays(*a, **k):
        seen["rays"] = sampled(*a, **k)
        return seen["rays"]

    def spy_loss(rays_o, rays_d, gt_rgb, bg, alpha_mask, **k):
        seen.update(o=rays_o, d=rays_d, gt=gt_rgb, alpha=alpha_mask)
        return forward(rays_o, rays_d, gt_rgb, bg, alpha_mask, **k)

    monkeypatch.setattr(ttrainer, "sampled_rays", spy_rays)
    monkeypatch.setattr(tr, "forward_loss", spy_loss)
    m = tr.train_step(data)
    group = list(m["index"])
    assert len(group) == 2 and np.isfinite(float(m["loss"]))
    inds = seen["rays"]["inds"].numpy()                       # [2, 32], shared
    assert inds.shape == (2, 32) and (inds[0] == inds[1]).all()
    i = (inds % 5).astype(np.float32) + 0.5
    j = (inds // 5).astype(np.float32) + 0.5
    o, d = _rays_from_pixels(jnp.asarray(data.poses[group]), jnp.asarray(i), jnp.asarray(j),
                             *data.intrinsics)
    np.testing.assert_allclose(seen["o"].numpy(), np.asarray(o).reshape(-1, 3), atol=1e-6)
    np.testing.assert_allclose(seen["d"].numpy(), np.asarray(d).reshape(-1, 3), atol=1e-6)
    pix = np.take_along_axis(data.images[group].reshape(2, 30, 4), inds[..., None], axis=1)
    pix = pix.reshape(-1, 4).astype(np.float32) / 255.0
    np.testing.assert_allclose(seen["alpha"].numpy(), pix[:, 3], atol=1e-7)
    assert int(tr.applied_steps) == 1


# ------------------------------------------------------ env on the sphere

def test_render_env_on_sphere_renders_the_sphere_as_jax(tmp_path):
    """``render_env_on_sphere`` outside sphere mode: no grid, one env net,
    the SDF net conditioned on a material; renders go through the sphere
    renderer (JAX's ``mode="sphere"``; its scene mode asks for a material it
    is not given), and the env index is moot."""
    from envidr_tpu_torch.data.env_dataset import generate_env_sphere
    kw = dict(CP_SMALL, env_sph_mode=False, render_env_on_sphere=True)
    ini = os.path.join(ROOT, "configs", "neural_renderer_cp.ini")
    with f32_cp_encoder():
        jopt = jax_load(ini, workspace=str(tmp_path), **kw)
        jt = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path))
        topt = torch_load(ini, **kw)
        tcfg = torch_netcfg(topt)
        params = jax.tree.map(np.asarray, jt.state["ema"])
        tr = Trainer(topt, tcfg, device="cpu", net=load_jax_params(NeRFNetwork(tcfg), params))
        assert not tr.use_grid and not jt.use_grid and not tcfg.env_sph_mode
        assert (tcfg.in_roughness, tcfg.in_metallic, tcfg.in_base_color) == (1, 1, 3)
        assert {n for n, _ in tr.net.named_children()} == set(params) and "env_net" in params
        pose = trays.nerf_matrix_to_ngp(trays.pose_spherical(30.0, -30.0, 4.0), scale=topt.scale)
        mat = {"roughness": 0.3, "metallic": 0.5, "color": [0.6, 0.5, 0.4]}
        intr = (20.0, 20.0, 8.0, 8.0)
        ref = jt.render_image(pose, intr, 16, 16, mode="sphere", material=mat, env_index=3)
        with pytest.raises(AssertionError, match="material"):
            jt.render_image(pose, intr, 16, 16, mode="scene", material=mat)
        ours = tr.render_image(pose, intr, 16, 16, material=mat, env_index=3)
    np.testing.assert_allclose(ours["image"], ref["image"], rtol=0, atol=IMAGE_ATOL)
    assert 0.0 < ours["weights_sum"].mean() < 1.0
    data = generate_env_sphere("train", 2, size=24, env_res=8, device="cpu")
    m = tr.train_step(data)
    assert np.isfinite(float(m["loss"])) and "mean_count" not in m
