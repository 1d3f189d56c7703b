"""The procedural three-sphere scene that every cell trains on,
made by the benchmark from numpy alone.

Three Lambertian spheres under one directional light, rendered exactly
(ray-sphere hits) into uint8 RGBA views at 400x400 from cameras on a
sphere of radius 3, the NeRF-synthetic layout of ``tools/gen_synth_scene.py``
(50 train views drawn with seed 0), posed in the
NGP convention at ``scale``.  :class:`SceneSplit` is what the program's
``Trainer.train_step`` reads (``images``, ``poses``, ``intrinsics``,
``H``, ``W``, ``C``, ``device_images``, ``epoch_order``) and what the
reference reads as the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

SIZE = 400
SPLITS = {"train": (50, 0)}        # (views, pose seed)
SPHERES = [  # centre, radius, albedo
    (np.array([0.0, 0.0, 0.0]), 0.42, np.array([0.85, 0.25, 0.2])),
    (np.array([0.45, 0.25, -0.1]), 0.22, np.array([0.2, 0.55, 0.9])),
    (np.array([-0.4, -0.3, 0.25]), 0.18, np.array([0.95, 0.8, 0.25])),
]
LIGHT = np.array([0.5, 0.6, -0.62]) / np.linalg.norm([0.5, 0.6, -0.62])


def _pose(theta: float, phi: float, radius: float = 3.0) -> np.ndarray:
    trans = np.eye(4)
    trans[2, 3] = radius
    rp = np.eye(4)
    c, s = np.cos(phi), np.sin(phi)
    rp[1:3, 1:3] = [[c, -s], [s, c]]
    rt = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = c, -s, s, c
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])
    return flip @ rt @ rp @ trans


def _render(c2w: np.ndarray, size: int, focal: float) -> np.ndarray:
    i, j = np.meshgrid(np.arange(size) + 0.5, np.arange(size) + 0.5)
    dirs = np.stack([(i - size / 2) / focal, -(j - size / 2) / focal, -np.ones_like(i)], -1)
    dirs = dirs @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    best = np.full((size, size), np.inf)
    rgb = np.zeros((size, size, 3))
    hit = np.zeros((size, size), bool)
    for centre, radius, albedo in SPHERES:
        oc = o - centre
        b = np.sum(dirs * oc, -1)
        disc = b * b - (np.dot(oc, oc) - radius ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        m = (disc > 0) & (t > 0) & (t < best)
        n = (o + dirs * t[..., None] - centre) / radius
        shade = 0.25 + 0.75 * np.clip(np.sum(n * LIGHT, -1), 0, 1)
        rgb = np.where(m[..., None], albedo * shade[..., None], rgb)
        best = np.where(m, t, best)
        hit |= m
    img = np.concatenate([rgb, hit[..., None].astype(float)], -1)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _to_ngp(p: np.ndarray, scale: float) -> np.ndarray:
    return np.array([[p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] * scale],
                     [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] * scale],
                     [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] * scale],
                     [0, 0, 0, 1]], dtype=np.float32)


class SceneSplit:
    """One split: ``images`` uint8 [B, H, W, 4], ``poses`` float32
    [B, 4, 4] (NGP c2w), ``intrinsics`` (fx, fy, cx, cy).  ``size`` below
    400 renders the same cameras at a smaller resolution (CPU tests)."""

    def __init__(self, split: str, scale: float, size: int = SIZE):
        n, seed = SPLITS[split]
        rng = np.random.default_rng(seed)
        c2ws = []
        for _ in range(n):
            theta = rng.uniform(0, 2 * np.pi)
            phi = rng.uniform(-0.5 * np.pi, 0.1)
            c2ws.append(_pose(theta, phi))
        focal = size * 1.25
        self.images = np.stack([_render(c, size, focal) for c in c2ws])
        self.poses = np.stack([_to_ngp(np.array(c.tolist(), np.float32), scale) for c in c2ws])
        self.H = self.W = size
        self.C = 4
        fl = float(size / (2 * np.tan(np.arctan(size / (2 * focal)))))
        self.intrinsics = (fl, fl, size / 2, size / 2)

    def __len__(self):
        return self.poses.shape[0]

    def device_images(self, device) -> torch.Tensor:
        """uint8 [B, H*W, C] on ``device``."""
        return torch.from_numpy(self.images.reshape(len(self), self.H * self.W, self.C)).to(device)

    def epoch_order(self, rng: np.random.Generator):
        idx = np.arange(len(self))
        rng.shuffle(idx)
        return idx
