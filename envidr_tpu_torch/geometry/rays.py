"""Camera poses, ray generation and analytic geometry helpers.

Counterpart of ``envidr_tpu/geometry/rays.py`` (the functions the scene and
sphere training paths reach, and the spherical camera pose of the env-sphere
set).  Random draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

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


def sampled_rays(generator: Optional[torch.Generator], poses: torch.Tensor, intrinsics,
                 H: int, W: int, N: int):
    """N uniformly drawn pixel rays shared by the B poses: rays_o, rays_d
    [B, N, 3] and flat pixel indices inds [B, N]."""
    fx, fy, cx, cy = intrinsics
    B = poses.shape[0]
    inds = torch.randint(0, H * W, (N,), generator=generator, device=poses.device)
    inds = inds[None].expand(B, N)
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    rays_o, rays_d = _rays_from_pixels(poses, i, j, fx, fy, cx, cy)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds}


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
    fx, fy, cx, cy = intrinsics
    inds_x = torch.div(inds_coarse, 128, rounding_mode="floor")
    inds_y = inds_coarse % 128
    sx, sy = H / 128.0, W / 128.0
    ix = torch.clamp((inds_x * sx + fx_r * sx).to(torch.int32), 0, H - 1)
    iy = torch.clamp((inds_y * sy + fy_r * sy).to(torch.int32), 0, W - 1)
    inds = ix.long() * W + iy.long()
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    rays_o, rays_d = _rays_from_pixels(poses, i, j, fx, fy, cx, cy)
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds, "inds_coarse": inds_coarse}


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
