"""Analytic PBR sphere renderer: the ground truth of the env-sphere pretrain.

Counterpart of ``envidr_tpu/render/pbr.py``: Filament's split-sum IBL model
(a cosine-convolved irradiance map for the diffuse lobe, a roughness mip
chain of Phong-lobe prefiltered radiance for the specular one, and the
Karis/Lazarov analytic environment BRDF), over a bank of procedural HDRIs.

The procedural envmaps are drawn on the host with numpy, draw for draw as
the JAX package draws them.  The prefilter and the sphere render run in
torch, in float64, on the device given: the prefilter of a 64x128 envmap
multiplies 8192x8192 cosine matrices, a few matmuls on a card and seconds
of numpy on a CPU.  The few scalars and 3-vectors that numpy computes in
float32 (the camera's ``o.o``, the material's albedo and F0) are computed
by numpy here too, so that every rounding is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.geometry.lighting import gen_light_xyz

ROUGHNESS_MIPS = np.array([0.03, 0.1, 0.2, 0.35, 0.55, 0.8, 1.0])


def procedural_envmap(seed: int, H: int = 64, W: int = 128) -> np.ndarray:
    """A random plausible outdoor/indoor HDRI [H, W, 3] (linear radiance)."""
    rng = np.random.default_rng(seed * 7919 + 13)
    xyz, _ = gen_light_xyz(H, W, 1.0)
    up = xyz[..., 2]

    sky_top = rng.uniform(0.3, 1.2, 3) * rng.uniform(0.5, 1.5)
    sky_hor = rng.uniform(0.2, 0.9, 3)
    ground = rng.uniform(0.05, 0.4, 3)
    t = np.clip(up, 0, 1)[..., None]
    env = (1 - t) * sky_hor + t * sky_top
    env = np.where(up[..., None] < 0,
                   ground + (sky_hor - ground) * np.clip(1 + up, 0, 1)[..., None] ** 2,
                   env)

    n_lights = rng.integers(1, 4)
    for _ in range(n_lights):
        d = rng.normal(size=3)
        d[2] = abs(d[2]) * rng.choice([1.0, 1.0, -0.3])
        d /= np.linalg.norm(d)
        sharp = rng.uniform(30, 400)
        intensity = rng.uniform(3.0, 25.0)
        color = rng.uniform(0.6, 1.0, 3) * intensity
        cos = np.clip(xyz @ d, 0, 1)
        env = env + color * np.exp(sharp * (cos - 1.0))[..., None]

    # a few coloured bounce blobs
    for _ in range(rng.integers(0, 3)):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        cos = np.clip(xyz @ d, 0, 1)
        env = env + rng.uniform(0.1, 0.6, 3) * np.exp(40 * (cos - 1.0))[..., None]
    return env.astype(np.float32)


def make_env_bank(n: int = 11, H: int = 64, W: int = 128) -> np.ndarray:
    return np.stack([procedural_envmap(i, H, W) for i in range(n)])


def _latlong_pixel(dirs: torch.Tensor, H: int, W: int):
    """Nearest pixel (y, x) of the lat-long map for unit ``dirs`` [..., 3]
    (``dir_to_latlong_uv`` then truncation, as the JAX package looks up)."""
    x, y, z = dirs.unbind(-1)
    r = torch.sqrt(x * x + y * y + z * z)
    lat = torch.asin(torch.clamp(z / r.clamp_min(1e-12), -1, 1))
    lng = torch.atan2(y, x)
    v = torch.clamp(0.5 - lat / np.pi, 0.0, 1.0)
    u = torch.remainder(0.5 - lng / (2 * np.pi), 1.0)
    px = torch.clamp((u * W).long(), 0, W - 1)
    py = torch.clamp((v * H).long(), 0, H - 1)
    return py, px


class PrefilteredEnv:
    """Irradiance map and roughness mip chain of one envmap, float64 on
    ``device`` (the card unless the CPU is asked for): ``irradiance``
    [P, 3], ``spec_mips`` [R, P, 3]."""

    def __init__(self, env: np.ndarray, device=None):
        H, W, _ = env.shape
        dirs, areas = gen_light_xyz(H, W, 1.0)
        dev = resolve_device(device)
        d = torch.from_numpy(dirs.reshape(-1, 3)).to(dev)
        a = torch.from_numpy(areas.reshape(-1, 1)).to(dev)
        # pre-weighted radiance env * dOmega / 4pi
        L = torch.from_numpy(env.reshape(-1, 3).astype(np.float64)).to(dev) * a / (4 * np.pi)
        cos = torch.clamp(d @ d.T, 0, 1)
        self.irradiance = (cos @ L) * (4.0 * np.pi)
        a4 = a / (4 * np.pi)
        mips = []
        for r in ROUGHNESS_MIPS:
            alpha = max(r * r, 1e-3)
            w = torch.pow(cos, min(2.0 / alpha ** 2, 5000.0))   # Phong-lobe approx of GGX
            mips.append((w @ L) / torch.clamp(w @ a4, min=1e-9))
            del w
        self.spec_mips = torch.stack(mips)
        self.H, self.W = H, W

    def _lookup(self, table: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        py, px = _latlong_pixel(dirs, self.H, self.W)
        return table.reshape(self.H, self.W, 3)[py, px]

    def irradiance_at(self, n: torch.Tensor) -> torch.Tensor:
        return self._lookup(self.irradiance, n)

    def specular_at(self, r_dir: torch.Tensor, roughness: float) -> torch.Tensor:
        idx = np.interp(roughness, ROUGHNESS_MIPS, np.arange(len(ROUGHNESS_MIPS)))
        lo, hi = int(np.floor(idx)), int(np.ceil(idx))
        t = idx - lo
        return ((1 - t) * self._lookup(self.spec_mips[lo], r_dir)
                + t * self._lookup(self.spec_mips[hi], r_dir))


def env_brdf_approx(n_dot_v: torch.Tensor, roughness: float):
    """Lazarov's analytic env-BRDF fit: (scale, bias) of F0."""
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], dtype=n_dot_v.dtype, device=n_dot_v.device)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], dtype=n_dot_v.dtype, device=n_dot_v.device)
    r = torch.full_like(n_dot_v, roughness)
    rr = r[..., None] * c0 + c1
    a004 = torch.minimum(rr[..., 0] * rr[..., 0], torch.exp2(-9.28 * n_dot_v)) \
        * rr[..., 0] + rr[..., 1]
    return a004 * -1.04 + rr[..., 2], a004 * 1.04 + rr[..., 3]


def render_pbr_sphere(pre: PrefilteredEnv, c2w: np.ndarray, intrinsics, H: int, W: int, *,
                      radius: float = 0.95, roughness: float = 0.3, metallic: float = 0.0,
                      base_color=(0.8, 0.8, 0.8), reflectance: float = 0.5, bg=None,
                      with_alpha: bool = True) -> torch.Tensor:
    """The sphere of ``radius`` at the origin seen by the NGP-convention
    camera ``c2w`` [4, 4]: linear radiance [H, W, 3] (and the hit mask as a
    fourth channel with ``with_alpha``), float32 on ``pre``'s device.
    ``bg`` None shows the envmap's sharpest mip behind the sphere."""
    dev = pre.irradiance.device
    f64 = dict(dtype=torch.float64, device=dev)
    fx, fy, cx, cy = intrinsics
    c2w = np.asarray(c2w)
    j, i = torch.meshgrid(torch.arange(H, **f64) + 0.5, torch.arange(W, **f64) + 0.5,
                          indexing="ij")
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], -1)
    dirs = dirs / torch.sqrt((dirs * dirs).sum(-1, keepdim=True))
    dirs = dirs @ torch.from_numpy(c2w[:3, :3].T.astype(np.float64)).to(dev)
    o_np = c2w[:3, 3]
    o = torch.from_numpy(o_np.astype(np.float64)).to(dev)

    b = (dirs * o).sum(-1)
    c = float(np.dot(o_np, o_np) - radius ** 2)     # numpy's dtype and rounding
    disc = b * b - c
    t = -b - torch.sqrt(disc.clamp_min(0))
    hit = (disc > 0) & (t > 0)
    n = (o + dirs * t[..., None]) / radius
    v = -dirs
    n_dot_v = torch.clamp((n * v).sum(-1), 1e-4, 1.0)
    r_dir = 2 * n_dot_v[..., None] * n - v

    albedo = np.asarray(base_color, np.float32)[:3]
    f0 = torch.from_numpy(
        (0.16 * reflectance ** 2 * (1 - metallic) + albedo * metallic).astype(np.float64)).to(dev)
    kd = torch.from_numpy((albedo * (1 - metallic)).astype(np.float64)).to(dev)

    diffuse = kd * pre.irradiance_at(n) / np.pi
    spec_L = pre.specular_at(r_dir, roughness)
    scale, bias = env_brdf_approx(n_dot_v, roughness)
    rgb = diffuse + spec_L * (f0 * scale[..., None] + bias[..., None])
    if bg is None:
        bg_rgb = pre._lookup(pre.spec_mips[0], dirs)
    else:
        bg_rgb = torch.from_numpy(np.asarray(bg, np.float32).astype(np.float64)).to(dev) \
            .expand(H, W, 3)
    out = torch.where(hit[..., None], rgb, bg_rgb)
    if with_alpha:
        out = torch.cat([out, hit[..., None].double()], -1)
    return out.float()
