"""The env-sphere set of the port against the JAX package and its tool:

* the lat-long helpers, the procedural env bank, the prefilter (at 16x32)
  and the analytic PBR sphere render (at 32x32) against the JAX package's
  numpy (``render/pbr.py``, ``geometry/lighting.py``);
* the in-memory generator against the files ``tools/gen_env_dataset.py``
  writes, run here at 32x32 with an 8x16 env bank: the same materials,
  poses, env indices and 8-bit images, mirror images included;
* the port's ``EnvSphereDataset`` (its own PNG decoder) against the JAX
  package's (imageio) on those files and on the tracked
  ``data/env_sphere_renv`` val split, whose first views the generator
  makes pixel for pixel at full size;
* the Radiance HDR reader and `build_env_bank_from_dir` on files the test
  writes (the writers of tests/test_hdri.py).

No test prefilters a 64x128 envmap in numpy (13 s an env on a CPU)."""

import os
import sys

import numpy as np
import pytest
import torch

from envidr_tpu.data.env_dataset import EnvSphereDataset as JaxEnvSphereDataset
from envidr_tpu.geometry import lighting as jlight
from envidr_tpu.render import pbr as jpbr
from envidr_tpu_torch.data import hdri
from envidr_tpu_torch.data.env_dataset import (
    EnvSphereDataset, PrefilteredBank, generate_env_sphere, sample_material,
)
from envidr_tpu_torch.geometry import lighting
from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp, pose_spherical
from envidr_tpu_torch.render import pbr
from test_hdri import _write_hdr_flat, _write_hdr_rle
from test_torch_helpers import ROOT

RENV_DATA = os.path.join(ROOT, "data", "env_sphere_renv")
# float64 prefilter sums in another order (torch against numpy)
PREFILTER_RTOL = 1e-10
# the f32 render of both, from float64 sums in another order
RENDER_ATOL = 1e-6


def test_lighting_helpers_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    for a, b in zip(lighting.cart2sph(v), jlight.cart2sph(v)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lighting.sph2cart(1.5, 0.3, -2.0), jlight.sph2cart(1.5, 0.3, -2.0))
    np.testing.assert_array_equal(lighting.uniform_sample_sph(16, 2.0, seed=3),
                                  jlight.uniform_sample_sph(16, 2.0, seed=3))
    for a, b in zip(lighting.gen_light_xyz(8, 16), jlight.gen_light_xyz(8, 16)):
        np.testing.assert_array_equal(a, b)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for a, b in zip(lighting.dir_to_latlong_uv(v), jlight.dir_to_latlong_uv(v)):
        np.testing.assert_array_equal(a, b)


def test_pose_spherical_matches_jax():
    from envidr_tpu.geometry.rays import pose_spherical as jpose
    for theta, phi in ((0.0, 0.0), (123.4, -56.7), (359.0, 89.0)):
        np.testing.assert_array_equal(pose_spherical(theta, phi, 4.0), jpose(theta, phi, 4.0))


def test_env_bank_matches_jax():
    np.testing.assert_array_equal(pbr.make_env_bank(11, 8, 16), jpbr.make_env_bank(11, 8, 16))
    np.testing.assert_array_equal(pbr.procedural_envmap(4, 16, 32),
                                  jpbr.procedural_envmap(4, 16, 32))


@pytest.fixture(scope="module")
def prefiltered():
    env = jpbr.procedural_envmap(2, 16, 32)
    return pbr.PrefilteredEnv(env, "cpu"), jpbr.PrefilteredEnv(env)


def test_prefilter_matches_jax(prefiltered):
    ours, ref = prefiltered
    np.testing.assert_allclose(ours.irradiance.numpy(), ref.irradiance, rtol=PREFILTER_RTOL)
    np.testing.assert_allclose(ours.spec_mips.numpy(), ref.spec_mips, rtol=PREFILTER_RTOL)


@pytest.mark.parametrize("material", [
    dict(roughness=0.3, metallic=0.0, base_color=(0.8, 0.8, 0.8), bg=None),
    dict(roughness=0.02, metallic=0.9, base_color=(0.9, 0.7, 0.2), bg=(0, 0, 0)),
    dict(roughness=0.9, metallic=0.4, base_color=(0.2, 0.5, 0.9), bg=(0, 0, 0)),
])
def test_render_pbr_sphere_matches_jax(prefiltered, material):
    ours, ref = prefiltered
    c2w = nerf_matrix_to_ngp(pose_spherical(40.0, 25.0, 4.0), scale=0.8)
    focal = 32 / (2 * np.tan(0.6194058656692505 / 2))
    intr = (focal, focal, 16.0, 16.0)
    a = pbr.render_pbr_sphere(ours, c2w, intr, 32, 32, **material).numpy()
    b = jpbr.render_pbr_sphere(ref, c2w, intr, 32, 32, **material)
    assert a.dtype == b.dtype == np.float32 and a.shape == (32, 32, 4)
    np.testing.assert_array_equal(a[..., 3], b[..., 3])
    assert 0 < a[..., 3].mean() < 1
    np.testing.assert_allclose(a, b, rtol=0, atol=RENDER_ATOL)


def test_sample_material_draws_as_the_tool(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import gen_env_dataset as tool
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(40):
        assert sample_material(r1) == tool.sample_material(r2)


@pytest.fixture(scope="module")
def tool_set(tmp_path_factory):
    """tools/gen_env_dataset.py run at 32x32 with an 8x16 bank: 3 train and
    2 val frames with mirror images."""
    out = str(tmp_path_factory.mktemp("env_set"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gen_env_dataset as tool
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["gen_env_dataset.py", out, "--n-train", "3", "--n-val", "2", "--n-test", "0",
                "--size", "32", "--env-res", "8", "--with-renv"]
    try:
        tool.main()
    finally:
        sys.argv = argv
    return out


@pytest.mark.parametrize("split,n", [("train", 3), ("val", 2)])
def test_generator_makes_what_the_tool_writes(tool_set, split, n):
    ref = JaxEnvSphereDataset(tool_set, split, scale=0.8, with_renv=True)
    ours = generate_env_sphere(split, n, size=32, env_res=8, with_renv=True, device="cpu")
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.r_images, ref._r_images)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    np.testing.assert_array_equal(ours.env_index, ref._env_idx)
    np.testing.assert_array_equal(ours.roughness, ref._rough)
    np.testing.assert_array_equal(ours.metallic, ref._metal)
    np.testing.assert_array_equal(ours.color, ref._color)
    assert ours.intrinsics == pytest.approx(ref.intrinsics, rel=1e-15)
    assert ours.images[..., 3].any() and (ours.images[..., 3] == 0).any()


def test_loader_reads_the_tool_files_as_jax(tool_set):
    ref = JaxEnvSphereDataset(tool_set, "train", scale=0.8, with_renv=True)
    ours = EnvSphereDataset(tool_set, "train", scale=0.8, with_renv=True)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.r_images, ref._r_images)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    cond = ours.conditioning("cpu").numpy()
    np.testing.assert_array_equal(cond[:, 0], ref._rough)
    np.testing.assert_array_equal(cond[:, 5], ref._env_idx)
    np.testing.assert_array_equal(cond[:, 2:5], ref._color[:, :3])
    assert ours.material(1) == {"roughness": float(ref._rough[1]),
                                "metallic": float(ref._metal[1]),
                                "color": ref._color[1].tolist()}


def test_loader_reads_the_tracked_renv_set_as_jax():
    ref = JaxEnvSphereDataset(RENV_DATA, "val", scale=0.8, with_renv=True)
    ours = EnvSphereDataset(RENV_DATA, "val", scale=0.8, with_renv=True)
    assert ours.images.shape == ref.images.shape == (12, 400, 400, 4)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.r_images, ref._r_images)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    np.testing.assert_array_equal(ours.env_index, ref._env_idx)
    assert ours.intrinsics == pytest.approx(ref.intrinsics, rel=1e-15)
    imgs = ours.device_images("cpu")
    assert imgs.shape == (12, 400 * 400, 4) and imgs.dtype == torch.uint8
    assert ours.device_r_images("cpu").shape == (12, 400 * 400, 3)
    assert EnvSphereDataset(RENV_DATA, "val", scale=0.8).r_images is None


def test_tracked_renv_set_is_the_generated_val_split():
    """data/env_sphere_renv's val views are the generator's, pixel for pixel
    at 400x400 with the 64x128 bank, mirror images included: the tool drew
    them with the default --max-roughness 1.0 (the config's comment names
    0.775)."""
    ref = EnvSphereDataset(RENV_DATA, "val", scale=0.8, with_renv=True)
    ours = generate_env_sphere("val", 2, with_renv=True, device="cpu")
    np.testing.assert_array_equal(ours.images, ref.images[:2])
    np.testing.assert_array_equal(ours.r_images, ref.r_images[:2])
    np.testing.assert_array_equal(ours.poses, ref.poses[:2])
    np.testing.assert_array_equal(ours.color, ref.color[:2])


@pytest.fixture
def env_img():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.02, 1.0, (16, 32, 3)).astype(np.float32)
    img[3:5, 10:14] *= 40.0
    return img


@pytest.mark.parametrize("writer", [_write_hdr_flat, _write_hdr_rle])
def test_hdr_reader_matches_jax(tmp_path, env_img, writer):
    from envidr_tpu.data.hdri import read_radiance_hdr as jread
    path = os.path.join(tmp_path, "e.hdr")
    writer(path, env_img)
    got = hdri.read_radiance_hdr(path)
    np.testing.assert_array_equal(got, jread(path))
    # one exponent for the three channels: the error is relative to the
    # pixel's largest channel (tests/test_hdri.py)
    rel = np.abs(got - env_img) / (env_img.max(axis=-1, keepdims=True) + 1e-6)
    assert rel.max() < 1.5 / 128.0


def test_env_bank_from_dir_matches_jax(tmp_path, env_img):
    from envidr_tpu.data.hdri import build_env_bank_from_dir as jbuild
    _write_hdr_rle(os.path.join(tmp_path, "a.hdr"), env_img)
    np.save(os.path.join(tmp_path, "b.npy"), env_img[::-1].copy())
    for H, W in ((8, 16), (12, 20)):
        np.testing.assert_array_equal(hdri.build_env_bank_from_dir(str(tmp_path), H, W),
                                      jbuild(str(tmp_path), H, W))
    open(os.path.join(tmp_path, "c.png"), "wb").close()
    with pytest.raises(RuntimeError, match="image library"):
        hdri.load_envmap(os.path.join(tmp_path, "c.png"))
    with pytest.raises(ValueError, match="unsupported"):
        hdri.load_envmap(os.path.join(tmp_path, "d.tif"))


def test_prefiltered_bank_prefilters_on_demand():
    pres = PrefilteredBank(pbr.make_env_bank(3, 8, 16), "cpu")
    assert len(pres) == 3 and pres[1].spec_mips.shape == (7, 128, 3)
    assert set(pres._pre) == {1} and pres[1] is pres[1]
    assert pres[1].irradiance.dtype == torch.float64
