"""Spherical-coordinate and environment-map utilities.

Counterpart of ``envidr_tpu/geometry/lighting.py`` for the functions the PBR
env bank reaches: ``cart2sph``, ``sph2cart``, ``uniform_sample_sph``,
``gen_light_xyz`` and ``dir_to_latlong_uv``.  numpy on the host, as there
(data preparation, not the train step).
"""

from __future__ import annotations

import numpy as np


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
