"""Mesh extraction: the SDF on a dense grid, marching tetrahedra, OBJ export
(counterpart of ``envidr_tpu/apps/mesh_extract.py``, the reference's
``extract_fields`` / ``extract_geometry`` / ``save_mesh``,
``nerf/utils.py:245-275, 898-928``).

The field is queried on the trainer's device in chunks of ``2**17`` points;
the tetrahedra run on the host, in the C++ of ``envidr_tpu_torch/native``
(:func:`marching_tets`) or, asked for by name, in numpy
(:func:`marching_tets_numpy`, the plain version the tests hold the C++ to).
Each grid cell splits into 6 tetrahedra; a tetrahedron with a sign change
gives 1-2 triangles whose vertices lie at the linearly interpolated zero
crossings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# cube corner offsets (binary order)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
# the 6-tetrahedron decomposition of the cube (corner indices)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
# tetrahedron edges (0,1),(0,2),(0,3),(1,2),(1,3),(2,3); for each inside
# pattern, its triangles as triples of edge indices
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
_CASES = {
    0b0001: [[0, 1, 2]],
    0b0010: [[0, 4, 3]],
    0b0100: [[1, 3, 5]],
    0b1000: [[2, 5, 4]],
    0b0011: [[1, 2, 4], [1, 4, 3]],
    0b0101: [[0, 3, 5], [0, 5, 2]],
    0b1001: [[0, 1, 5], [0, 5, 4]],
    0b0110: [[0, 4, 5], [0, 5, 1]],
    0b1010: [[0, 2, 5], [0, 5, 3]],
    0b1100: [[1, 3, 4], [1, 4, 2]],
    0b0111: [[2, 5, 4]],
    0b1011: [[1, 3, 5]],
    0b1101: [[0, 4, 3]],
    0b1110: [[0, 1, 2]],
}
FIELD_CHUNK = 2 ** 17


def marching_tets(field: np.ndarray, iso: float = 0.0):
    """``field`` [R, R, R] -> (verts [V, 3] in voxel coordinates, faces
    [F, 3]), triangles oriented so that normals point toward a decreasing
    field (mesh ``-sdf`` for outward normals, as ``utils.py:907-910`` does).
    The C++ version (``native/mtets.cpp``); a failed build raises."""
    from envidr_tpu_torch.native import marching_tets_native
    return marching_tets_native(np.asarray(field, np.float32) - iso, 0.0)


def marching_tets_numpy(field: np.ndarray, iso: float = 0.0):
    """The plain numpy version of :func:`marching_tets`: vertices welded on
    a 1/1024-voxel lattice, degenerate faces dropped."""
    R = field.shape[0]
    g = np.stack(np.meshgrid(np.arange(R - 1), np.arange(R - 1), np.arange(R - 1),
                             indexing="ij"), -1).reshape(-1, 3)
    corner_pos = g[:, None, :] + _CORNERS[None]                     # [C, 8, 3]
    corner_val = field[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]] - iso

    verts_list, faces_list = [], []
    n_verts = 0
    for tet in _TETS:
        v = corner_val[:, tet]                                      # [C, 4]
        p = corner_pos[:, tet].astype(np.float64)                   # [C, 4, 3]
        inside = (v < 0).astype(np.int32)
        code = inside[:, 0] | (inside[:, 1] << 1) | (inside[:, 2] << 2) | (inside[:, 3] << 3)
        for pattern, tris in _CASES.items():
            m = code == pattern
            if not m.any():
                continue
            vm, pm = v[m], p[m]
            # the zero crossing on each of the 6 edges
            a = vm[:, _TET_EDGES[:, 0]]
            b = vm[:, _TET_EDGES[:, 1]]
            t = np.clip(a / np.where(np.abs(a - b) < 1e-12, 1e-12, a - b), 0.0, 1.0)[..., None]
            pa = pm[:, _TET_EDGES[:, 0]]
            pb = pm[:, _TET_EDGES[:, 1]]
            epos = pa + t * (pb - pa)                               # [M, 6, 3]
            for tri in tris:
                tv = epos[:, tri]                                   # [M, 3, 3]
                M = tv.shape[0]
                verts_list.append(tv.reshape(-1, 3))
                faces_list.append(n_verts + np.arange(M * 3).reshape(M, 3))
                n_verts += M * 3
    if not verts_list:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_list)
    faces = np.concatenate(faces_list)
    keys, inv = np.unique(np.round(verts * 1024).astype(np.int64), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    out_verts = np.zeros((len(keys), 3))
    out_verts[inv] = verts
    faces = inv[faces]
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return out_verts, faces[ok]


@torch.no_grad()
def extract_fields(query_fn, resolution: int = 256, bound: float = 1.0,
                   chunk: int = FIELD_CHUNK, device=None) -> np.ndarray:
    """``query_fn`` (points [n, 3] on ``device`` -> values [n]) on the
    ``resolution``^3 grid of ``linspace(-bound, bound)`` (``utils.py:245-260``),
    ``chunk`` points a call, the points made on the device; float32 [R, R, R]
    on the host, read back once."""
    R = resolution
    xs = torch.from_numpy(np.linspace(-bound, bound, R, dtype=np.float32)).to(device)
    out = torch.empty(R ** 3, dtype=torch.float32, device=device)
    for s in range(0, R ** 3, chunk):
        i = torch.arange(s, min(s + chunk, R ** 3), device=device)
        pts = torch.stack([xs[i // (R * R)], xs[(i // R) % R], xs[i % R]], dim=-1)
        out[s:s + chunk] = query_fn(pts).float()
    return out.reshape(R, R, R).cpu().numpy()


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")


def mesh_field(trainer, resolution: int = 256) -> np.ndarray:
    """The EMA network's SDF (or density) on the grid, on its device."""
    net, cfg = trainer.ema_net, trainer.cfg

    def query(pts):
        geo = net.forward_geometry(pts)
        return geo["sdf"] if cfg.use_sdf else geo["sigma"]

    return extract_fields(query, resolution, cfg.bound, device=trainer.device)


def mesh_from_field(field: np.ndarray, cfg):
    """Marching tetrahedra on ``-sdf`` at 0 (a density field at 10), the
    vertices in world units."""
    if cfg.use_sdf:
        verts, faces = marching_tets(-field, iso=0.0)
    else:
        verts, faces = marching_tets(field, iso=10.0)
    R = field.shape[0]
    return verts / (R - 1) * 2 * cfg.bound - cfg.bound, faces


def save_mesh(trainer, path: str, resolution: int = 256):
    """``utils.py:898-928``: the field, marching tetrahedra, an OBJ at
    ``path``; returns (verts, faces)."""
    t0 = time.perf_counter()
    field = mesh_field(trainer, resolution)
    t1 = time.perf_counter()
    verts, faces = mesh_from_field(field, trainer.cfg)
    t2 = time.perf_counter()
    write_obj(path, verts, faces)
    print(f"[mesh] {path}: {len(verts)} verts, {len(faces)} faces "
          f"(field {t1 - t0:.2f} s, marching tets {t2 - t1:.2f} s)")
    return verts, faces
