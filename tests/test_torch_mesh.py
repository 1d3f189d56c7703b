"""Mesh extraction of the port (``apps/mesh_extract.py``, ``native/``)
against the JAX package's, on the CPU: the numpy marching tetrahedra on the
same field, the C++ version against the numpy one, the OBJ bytes, and
``save_mesh`` of the trained CP checkpoint at resolution 40 against the
JAX package's field and marching tetrahedra."""

import os
import pickle

import numpy as np
import pytest

from envidr_tpu_torch.apps import mesh_extract
from test_torch_helpers import ROOT, one_torch_thread_fixture

one_torch_thread = one_torch_thread_fixture()

CP_CKPT = os.path.join(ROOT, "assets", "neus_cp_long_best.ckpt")
CP_INI = os.path.join(ROOT, "configs", "synth_spheres_cp.ini")
MESH_RES = 40
# the CP checkpoint's SDF on the grid, port against JAX's forward op by op
# (not jitted, so both make the bf16 CP encoder's roundings, trap C3):
# readings over the 64000 points, max 4.5e-8 and mean 7.6e-9 of an SDF in
# [-0.11, 0.15]
FIELD_ATOL, FIELD_MEAN = 1e-5, 1e-6
COUNT_RTOL = 0.01                    # welded vertices and faces; reading: equal
# mean |analytic SDF| of the vertices, world units; reading 0.0148 (the
# 40^3 grid's cells are 0.05 wide)
SURFACE_MEAN = 0.03


def sphere_field(R: int, radius: float = 0.55, center=(0.05, -0.1, 0.0)):
    xs = np.linspace(-1, 1, R)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return -(np.linalg.norm(g - np.asarray(center), axis=-1) - radius).astype(np.float32)


def welded(verts):
    return set(map(tuple, np.round(verts * 1024).astype(np.int64)))


@pytest.mark.parametrize("iso", [0.0, 0.1])
def test_numpy_marching_tets_equals_jax(iso):
    from envidr_tpu.apps.mesh_extract import marching_tets as jax_mt
    field = sphere_field(20)
    v, f = mesh_extract.marching_tets_numpy(field, iso)
    jv, jf = jax_mt(field, iso=iso, use_native=False)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert len(f) > 100


def test_native_equals_numpy():
    field = sphere_field(28)
    nv, nf = mesh_extract.marching_tets(field)
    rv, rf = mesh_extract.marching_tets_numpy(field)
    assert nv.shape == rv.shape and nf.shape == rf.shape
    assert welded(nv) == welded(rv)
    # the same triangles, each as its set of welded corners
    tris = lambda v, f: sorted(tuple(sorted(map(tuple, np.round(v[t] * 1024).astype(np.int64))))
                               for t in f)
    assert tris(nv, nf) == tris(rv, rf)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from envidr_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        mesh_extract.marching_tets(sphere_field(8))


def test_write_obj_bytes_equal_jax(tmp_path):
    from envidr_tpu.apps.mesh_extract import write_obj as jax_write_obj
    v, f = mesh_extract.marching_tets_numpy(sphere_field(12))
    mesh_extract.write_obj(str(tmp_path / "a.obj"), v, f)
    jax_write_obj(str(tmp_path / "b.obj"), v, f)
    a, b = (tmp_path / "a.obj").read_bytes(), (tmp_path / "b.obj").read_bytes()
    assert a == b and a.count(b"\nf ") == len(f)


def test_save_mesh_of_the_cp_checkpoint_matches_jax(tmp_path, capsys):
    import jax
    import jax.numpy as jnp
    from envidr_tpu.apps import mesh_extract as jax_mesh
    from envidr_tpu.config import load_options as jax_load, network_config as jax_netcfg
    from envidr_tpu.models.network import forward_geometry
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    opt = load_options(CP_INI)
    tr = Trainer(opt, network_config(opt), device="cpu")
    assert tr.load_checkpoint(CP_CKPT)
    field = mesh_extract.mesh_field(tr, MESH_RES)
    verts, faces = mesh_extract.save_mesh(tr, str(tmp_path / "port.obj"), MESH_RES)
    assert "[mesh]" in capsys.readouterr().out

    cfg = jax_netcfg(jax_load(CP_INI))
    with open(CP_CKPT, "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f)["ema"])
    ref = jax_mesh.extract_fields(lambda p: forward_geometry(params, cfg, p)["sdf"],
                                  MESH_RES, cfg.bound)
    err = np.abs(field - ref)
    assert err.max() <= FIELD_ATOL and err.mean() <= FIELD_MEAN, (err.max(), err.mean())
    # the body of JAX's save_mesh on the field just computed (its numpy tets)
    jv, jf = jax_mesh.marching_tets(-ref, iso=0.0, use_native=False)
    assert len(verts) > 1000
    assert abs(len(verts) - len(jv)) <= COUNT_RTOL * len(jv)
    assert abs(len(faces) - len(jf)) <= COUNT_RTOL * len(jf)
    # the vertices lie on the three spheres of data/synth_scene.py (NGP axes, scale 0.8)
    from envidr_tpu_torch.data.synth_scene import SPHERES
    d = np.min([np.linalg.norm(verts - 0.8 * c[[1, 2, 0]], axis=-1) - 0.8 * r
                for c, r, _ in SPHERES], axis=0)
    assert np.abs(d).mean() < SURFACE_MEAN, np.abs(d).mean()
