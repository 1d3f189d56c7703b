"""Camera poses, ray generation and analytic geometry helpers.

Counterpart of ``envidr_tpu/geometry/rays.py``.  Random draws take an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], dtype=np.float64)


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float64)


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float64)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-style spherical camera pose (``sph_loader.py:67-76``), f64."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float64) @ c2w


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 1.0, offset=(0, 0, 0)) -> np.ndarray:
    """NeRF (OpenGL) c2w -> NGP convention: axis permute + flip + scale/offset."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _rays_from_pixels(poses, i, j, fx, fy, cx, cy):
    zs = torch.ones_like(i)
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    directions = torch.stack([xs, ys, zs], dim=-1)
    directions = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    rays_d = directions @ poses[:, :3, :3].transpose(-1, -2)
    rays_o = poses[:, None, :3, 3].expand_as(rays_d)
    return rays_o, rays_d


def full_image_rays(poses: torch.Tensor, intrinsics, H: int, W: int):
    """Rays for every pixel.  poses: [B, 4, 4] c2w -> rays_o, rays_d [B, H*W, 3]."""
    fx, fy, cx, cy = intrinsics
    dev = poses.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    i = i.reshape(-1) + 0.5
    j = j.reshape(-1) + 0.5
    return _rays_from_pixels(poses, i[None], j[None], fx, fy, cx, cy)


def _pixel_rays(poses: torch.Tensor, intrinsics, W: int, inds: torch.Tensor):
    """The rays through the pixel centres of the flat indices ``inds`` [B, N]."""
    fx, fy, cx, cy = intrinsics
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    rays_o, rays_d = _rays_from_pixels(poses, i, j, fx, fy, cx, cy)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


def sampled_rays(generator: Optional[torch.Generator], poses: torch.Tensor, intrinsics,
                 H: int, W: int, N: int):
    """N uniformly drawn pixel rays shared by the B poses: rays_o, rays_d
    [B, N, 3] and flat pixel indices inds [B, N]."""
    inds = torch.randint(0, H * W, (N,), generator=generator, device=poses.device)
    return _pixel_rays(poses, intrinsics, W, inds[None].expand(poses.shape[0], N))


def patch_rays(generator: Optional[torch.Generator], poses: torch.Tensor, intrinsics,
               H: int, W: int, N: int, patch_size: int, *, corners=None):
    """``N // patch_size^2`` square patches of ``patch_size``^2 pixels each
    (``utils.py:136-153``), shared by the B poses.  A patch's top-left
    pixel (row ``ix`` in ``[0, H - patch_size)``, column ``iy`` in
    ``[0, W - patch_size)``) is drawn from ``generator``, or taken from
    ``corners`` = (ix, iy), two int tensors [N // patch_size^2]."""
    p, dev = patch_size, poses.device
    if corners is None:
        n = N // (p * p)
        ix = torch.randint(0, H - p, (n,), generator=generator, device=dev)
        iy = torch.randint(0, W - p, (n,), generator=generator, device=dev)
    else:
        ix, iy = (torch.as_tensor(c, dtype=torch.int64, device=dev) for c in corners)
    pi, pj = torch.meshgrid(torch.arange(p, device=dev), torch.arange(p, device=dev),
                            indexing="ij")
    rows = ix[:, None] + pi.reshape(-1)[None]                       # [n, p^2]
    cols = iy[:, None] + pj.reshape(-1)[None]
    inds = (rows * W + cols).reshape(-1)
    return _pixel_rays(poses, intrinsics, W, inds[None].expand(poses.shape[0], -1))


def center_crop_rays(generator: Optional[torch.Generator], poses: torch.Tensor, intrinsics,
                     H: int, W: int, N: int, center_crop: float, crop_ratio: float = 0.6, *,
                     draws=None):
    """Centre-weighted sampling (``utils.py:160-173``): ``int(N * crop_ratio)``
    rays uniform in the central window of ``center_crop`` of each side, the
    rest uniform over the image, shared by the B poses.  The draws (rows and
    columns inside the window, flat indices outside) come from ``generator``
    or from ``draws`` = (ic, jc, inds_bg)."""
    dev = poses.device
    pad = (1.0 - center_crop) / 2.0
    H_pad, W_pad = int(H * pad), int(W * pad)
    n_crop = int(N * crop_ratio)
    if draws is None:
        ic = torch.randint(0, H - 2 * H_pad, (n_crop,), generator=generator, device=dev)
        jc = torch.randint(0, W - 2 * W_pad, (n_crop,), generator=generator, device=dev)
        inds_bg = torch.randint(0, H * W, (N - n_crop,), generator=generator, device=dev)
    else:
        ic, jc, inds_bg = (torch.as_tensor(d, dtype=torch.int64, device=dev) for d in draws)
    inds = torch.cat([(ic + H_pad) * W + (jc + W_pad), inds_bg])
    return _pixel_rays(poses, intrinsics, W, inds[None].expand(poses.shape[0], N))


def error_map_rays(generator: Optional[torch.Generator], poses: torch.Tensor, intrinsics,
                   H: int, W: int, N: int, error_map: torch.Tensor):
    """N rays importance-sampled from each pose's [128*128] error map
    (``utils.py:174-186``): a coarse cell drawn with probability in
    proportion to its error (``torch.multinomial`` with replacement, in place
    of ``jax.random.categorical``), then a uniform pixel inside it.
    ``error_map`` [B, 128*128] -> rays_o, rays_d [B, N, 3], inds and
    inds_coarse [B, N]."""
    B = poses.shape[0]
    inds_coarse = torch.multinomial(error_map.clamp_min(1e-12), N, replacement=True,
                                    generator=generator)
    fx_r = torch.rand((B, N), generator=generator, device=poses.device)
    fy_r = torch.rand((B, N), generator=generator, device=poses.device)
    return error_map_draws_to_rays(poses, intrinsics, H, W, inds_coarse, fx_r, fy_r)


def error_map_draws_to_rays(poses: torch.Tensor, intrinsics, H: int, W: int,
                            inds_coarse: torch.Tensor, fx_r: torch.Tensor, fy_r: torch.Tensor):
    """The rays of error-map draws: the coarse cell ``inds_coarse`` [B, N] of
    the 128x128 map and a uniform offset ``(fx_r, fy_r)`` in [0, 1) inside it."""
    inds_x = torch.div(inds_coarse, 128, rounding_mode="floor")
    inds_y = inds_coarse % 128
    sx, sy = H / 128.0, W / 128.0
    ix = torch.clamp((inds_x * sx + fx_r * sx).to(torch.int32), 0, H - 1)
    iy = torch.clamp((inds_y * sy + fy_r * sy).to(torch.int32), 0, W - 1)
    rays = _pixel_rays(poses, intrinsics, W, ix.long() * W + iy.long())
    return {**rays, "inds_coarse": inds_coarse}


def reflect_dir(w_o: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """u = 2 (n.v) n - v; w_o points from the surface to the camera."""
    return 2.0 * (w_o * normals).sum(dim=-1, keepdim=True) * normals - w_o


def sphere_intersections(rays_o: torch.Tensor, rays_d: torch.Tensor, r: float = 1.0):
    """Ray-sphere hit (``sph_ray.py:19-32``): near [N, 1], far [N, 1] and
    mask [N] (the discriminant above -1e-4)."""
    ray_cam_dot = (rays_d * rays_o).sum(dim=-1, keepdim=True)
    nabla = ray_cam_dot ** 2 - ((rays_o * rays_o).sum(dim=-1, keepdim=True) - r ** 2)
    nabla_sqrt = torch.sqrt(nabla.clamp_min(0.0))
    return -ray_cam_dot - nabla_sqrt, -ray_cam_dot + nabla_sqrt, (nabla >= -1e-4)[..., 0]


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """(theta, phi) / pi of each ray's far hit on the background sphere of
    ``radius`` (``raymarching.cu:163-198``) -> [N, 2]."""
    _, far, _ = sphere_intersections(rays_o, rays_d, radius)
    p = rays_o + far * rays_d
    theta = torch.atan2(p[..., 1:2], torch.sqrt(p[..., 0:1] ** 2 + p[..., 2:3] ** 2)) / math.pi
    phi = torch.atan2(p[..., 0:1], p[..., 2:3]) / math.pi
    return torch.cat([theta, phi], dim=-1)


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor,
                       min_near: float = 0.2):
    """Slab test against [xmin ymin zmin xmax ymax zmax]; rays that miss get
    near = far = 1e10 (raymarching.cu:92-145)."""
    tiny = torch.where(rays_d >= 0, 1e-15, -1e-15)
    inv_d = 1.0 / torch.where(rays_d.abs() > 1e-15, rays_d, tiny)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = far < near
    big = torch.full_like(near, 1e10)
    near = torch.where(miss, big, near.clamp_min(min_near))
    far = torch.where(miss, big, torch.maximum(far, near))
    return near, far


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)
