"""The procedural three-sphere scene, generated in memory.

A copy of the analytic renderer of ``tools/gen_synth_scene.py``
(``pose_spherical``, ``render`` and the pose draws of ``write_split``) that
writes no files: the scene-training path of the port never reads a PNG.
:class:`SynthSpheres` holds one split as uint8 RGBA images with NGP poses
and intrinsics, as ``envidr_tpu/data/nerf_dataset.py:NeRFDataset`` would
load it from the generated directory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp

CANONICAL_SIZE = 400
SPLITS = {"train": (50, 0), "val": (5, 1), "test": (5, 2)}   # (frames, seed)

SPHERES = [  # center, radius, albedo
    (np.array([0.0, 0.0, 0.0]), 0.42, np.array([0.85, 0.25, 0.2])),
    (np.array([0.45, 0.25, -0.1]), 0.22, np.array([0.2, 0.55, 0.9])),
    (np.array([-0.4, -0.3, 0.25]), 0.18, np.array([0.95, 0.8, 0.25])),
]
LIGHT_DIR = np.array([0.5, 0.6, -0.62])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)


def pose_spherical(theta, phi, radius=3.0):
    trans = np.eye(4)
    trans[2, 3] = radius
    rp = np.eye(4)
    c, s = np.cos(phi), np.sin(phi)
    rp[1:3, 1:3] = [[c, -s], [s, c]]
    rt = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = c, -s, s, c
    return np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) \
        @ rt @ rp @ trans


def render(c2w, H, W, focal):
    """Exact ray-sphere hits, Lambert shading, alpha = hit -> uint8 [H, W, 4]."""
    i, j = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)          # OpenGL camera (-z forward)
    dirs = dirs @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    best_t = np.full((H, W), np.inf)
    rgb = np.zeros((H, W, 3))
    hit = np.zeros((H, W), bool)
    for center, radius, albedo in SPHERES:
        oc = o - center
        b = np.sum(dirs * oc, -1)
        c = np.dot(oc, oc) - radius**2
        disc = b * b - c
        m = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        m &= (t > 0) & (t < best_t)
        p = o + dirs * t[..., None]
        n = (p - center) / radius
        shade = 0.25 + 0.75 * np.clip(np.sum(n * LIGHT_DIR, -1), 0, 1)
        rgb = np.where(m[..., None], albedo[None, None] * shade[..., None], rgb)
        best_t = np.where(m, t, best_t)
        hit |= m
    img = np.concatenate([rgb, hit[..., None].astype(float)], -1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def split_poses(n: int, seed: int) -> np.ndarray:
    """The c2w poses ``write_split`` draws for a split: [n, 4, 4] float64."""
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(-0.5 * np.pi, 0.1)
        poses.append(pose_spherical(theta, phi))
    return np.stack(poses)


class SynthSpheres:
    """One split of the scene: ``images`` uint8 [B, H, W, 4], ``poses`` NGP
    c2w float32 [B, 4, 4], ``intrinsics`` (fx, fy, cx, cy)."""

    def __init__(self, split: str = "train", *, size: int = CANONICAL_SIZE,
                 n: Optional[int] = None, scale: float = 0.33, offset=(0, 0, 0),
                 downscale: int = 1):
        """``downscale`` keeps every ``downscale``-th pixel of each row and
        column, as ``NeRFDataset(..., downscale=...)`` subsamples the files."""
        n_default, seed = SPLITS[split]
        n = n_default if n is None else n
        focal = size * 1.25
        c2ws = split_poses(n, seed)
        self.images = np.stack([render(c, size, size, focal)[::downscale, ::downscale]
                                for c in c2ws])
        # the json round trip of write_split: float64 lists -> float32 arrays
        self.poses = np.stack([nerf_matrix_to_ngp(np.array(c.tolist(), np.float32),
                                                  scale=scale, offset=offset)
                               for c in c2ws])
        self.H, self.W = self.images.shape[1:3]
        self.C = 4
        # focal from camera_angle_x as NeRFDataset derives it
        camera_angle_x = 2 * np.arctan(size / (2 * focal))
        fl = self.W / (2 * np.tan(camera_angle_x / 2))
        self.intrinsics = (float(fl), float(fl), self.W / 2, self.H / 2)

    def __len__(self):
        return self.poses.shape[0]

    def device_images(self, device) -> torch.Tensor:
        """uint8 [B, H*W, C] on ``device``."""
        B = self.images.shape[0]
        return torch.from_numpy(self.images.reshape(B, self.H * self.W, self.C)).to(device)

    def epoch_order(self, rng: np.random.Generator, shuffle: bool = True):
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        return idx
