"""Spherical-coordinate, environment-map, camera-path and shadow-map
utilities.

Counterpart of ``envidr_tpu/geometry/lighting.py``: ``cart2sph``,
``sph2cart``, ``uniform_sample_sph``, ``gen_light_xyz``,
``dir_to_latlong_uv`` and ``gen_render_path`` in numpy on the host, as there
(data preparation and application code), and ``compute_visibility`` in torch
on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


def cart2sph(xyz: np.ndarray):
    """[..., 3] -> (r, lat, lng); lat in [-pi/2, pi/2] from the equator."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = np.sqrt(x * x + y * y + z * z)
    lat = np.arcsin(np.clip(z / np.maximum(r, 1e-12), -1, 1))
    lng = np.arctan2(y, x)
    return r, lat, lng


def sph2cart(r, lat, lng):
    z = r * np.sin(lat)
    x = r * np.cos(lat) * np.cos(lng)
    y = r * np.cos(lat) * np.sin(lng)
    return np.stack([x, y, z], axis=-1)


def uniform_sample_sph(n: int, r: float = 1.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * r


def gen_light_xyz(envmap_h: int, envmap_w: int, envmap_radius: float = 1.0):
    """Lat-long pixel directions and solid angles (lighting_util.py:396-431):
    (xyz [H, W, 3], areas [H, W])."""
    lat_step_size = np.pi / (envmap_h + 2)
    lng_step_size = 2 * np.pi / envmap_w
    lats = np.linspace(np.pi / 2 - lat_step_size, -np.pi / 2 + lat_step_size, envmap_h)
    lngs = np.linspace(np.pi, -np.pi + lng_step_size, envmap_w)
    lngs, lats = np.meshgrid(lngs, lats)
    xyz = sph2cart(envmap_radius, lats, lngs)
    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    return xyz, areas


def dir_to_latlong_uv(dirs: np.ndarray):
    """Unit directions -> (u, v) in [0, 1]^2 of the lat-long map of
    :func:`gen_light_xyz`."""
    _, lat, lng = cart2sph(dirs)
    v = 0.5 - lat / np.pi          # top = +pi/2
    u = 0.5 - lng / (2 * np.pi)    # longitudes run pi -> -pi left to right
    return u % 1.0, np.clip(v, 0.0, 1.0)


def gen_render_path(c2ws: np.ndarray, n_out: int) -> np.ndarray:
    """``n_out`` poses interpolated linearly through the key poses ``c2ws``
    [n, 4, 4], each rotation re-orthonormalised (``lighting_util.py:233``)."""
    n_in = len(c2ws)
    ts_in = np.linspace(0, 1, n_in)
    out = []
    for t in np.linspace(0, 1, n_out):
        i = min(int(t * (n_in - 1)), n_in - 2)
        a = (t - ts_in[i]) / (ts_in[i + 1] - ts_in[i] + 1e-12)
        m = (1 - a) * c2ws[i] + a * c2ws[i + 1]
        u, _, vt = np.linalg.svd(m[:3, :3])
        m[:3, :3] = u @ vt
        out.append(m)
    return np.stack(out)


def _grid_sample_border(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` [H, W] at ``u, v`` in [-1, 1]
    (align_corners, border padding): the ``F.grid_sample`` call of the
    reference's visibility reprojection, as the JAX package writes it."""
    H, W = img.shape
    x = ((u + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1)
    y = ((v + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1)
    x0 = torch.floor(x).long().clamp(0, W - 2)
    y0 = torch.floor(y).long().clamp(0, H - 2)
    fx, fy = x - x0, y - y0
    v00, v01 = img[y0, x0], img[y0, x0 + 1]
    v10, v11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)


def compute_visibility(cam_depth, light_depth, uv, cam_K, light_K, camrotc2w, cam_pos,
                       lightrotw2c, light_pos, depth_thres: float = 0.01,
                       soft_vis: bool = True, dot_bias: bool = False,
                       normals=None) -> torch.Tensor:
    """Shadow-map visibility by reprojecting camera depths into a light's
    view (``lighting_util.py:433-480``): lift the depths ``cam_depth`` [P]
    at pixels ``uv`` [P, 2] to world points, project them into the light
    camera, compare with its depth map ``light_depth`` [Hl, Wl] (bilinear,
    border padding) and return each pixel's visibility in [0, 1]: a hard
    test, or a soft ramp over ``depth_thres``; ``dot_bias`` scales the bias
    by the grazing angle of ``normals`` [P, 3] to the light.  ``cam_K`` and
    ``light_K`` are [3, 3] intrinsics, ``camrotc2w`` and ``lightrotw2c``
    [3, 3] rotations, ``cam_pos`` and ``light_pos`` [3]."""
    f_x, f_y, c_x, c_y = cam_K[0, 0], cam_K[1, 1], cam_K[0, 2], cam_K[1, 2]
    f_x_l, f_y_l, c_x_l, c_y_l = light_K[0, 0], light_K[1, 1], light_K[0, 2], light_K[1, 2]
    u, v = uv[..., 0], uv[..., 1]
    cam_c = torch.stack([(u - c_x) / f_x * cam_depth, (v - c_y) / f_y * cam_depth,
                         cam_depth], -1)
    world = cam_c @ camrotc2w.T + cam_pos
    light_dir = world - light_pos
    light_cam = light_dir @ lightrotw2c.T
    depth_reproj = light_cam[..., 2]
    uv_reproj = light_cam[..., :2] / depth_reproj[..., None]
    sample_depth = _grid_sample_border(light_depth, uv_reproj[..., 0] * f_x_l / c_x_l,
                                       uv_reproj[..., 1] * f_y_l / c_y_l)
    thres = torch.as_tensor(depth_thres, dtype=cam_depth.dtype, device=cam_depth.device)
    if dot_bias:
        ld = light_dir / torch.linalg.vector_norm(light_dir, dim=-1, keepdim=True).clamp_min(1e-10)
        nn = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-10)
        cos = (-ld * nn).sum(-1).clamp_min(0.0)
        thres = torch.clamp_min(depth_thres * (1.0 - cos), 0.5 * depth_thres)
    diff = depth_reproj - sample_depth
    if not soft_vis:
        return (~(diff > thres)).to(cam_depth.dtype)
    if not dot_bias:
        return 1.0 - torch.clamp(diff - thres, 0.0, depth_thres) / depth_thres
    return 1.0 - torch.clamp_max((diff - thres).clamp_min(0.0), depth_thres) / depth_thres
