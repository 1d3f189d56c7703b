"""The env-sphere set of the neural-renderer pretrain: a loader of a set on
disk and a generator of the procedural set in memory.

:class:`EnvSphereDataset` is the counterpart of
``envidr_tpu/data/env_dataset.py``: ``transforms_{split}.json`` with each
frame's pose, env index and material (roughness, metallic, colour), and,
with ``with_renv``, its mirror-sphere image ``renv_file_path``; images are
read by the port's PNG decoder.

:func:`generate_env_sphere` makes, in memory, the split that
``tools/gen_env_dataset.py`` writes to disk, and returns what
:class:`EnvSphereDataset` holds after reading those files: the same numpy
draws in the same order (the pose's theta in U[0, 360] and phi in
U[-90, 90], the env index, then the material; seeds train 0, val 1, test
2), the same analytic PBR render (:mod:`envidr_tpu_torch.render.pbr`), the
same 8-bit sRGB quantisation, and the poses as the loader converts the
json's.

The trainer reads ``len``, ``images``, ``poses``, ``intrinsics``, ``H``,
``W``, ``C``, ``device_images(device)``, ``epoch_order`` and, in sphere
mode, ``conditioning(device)``: one float32 tensor [B, 6] on the device
(roughness, metallic, colour, env index) from which a step indexes its
frame's row without a copy from the host, and ``device_r_images(device)``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from envidr_tpu_torch import resolve_device
from envidr_tpu_torch.data.png import read_pngs
from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp, pose_spherical
from envidr_tpu_torch.render.pbr import PrefilteredEnv, make_env_bank, render_pbr_sphere

# tools/gen_env_dataset.py's camera, sphere and seeds
CAMERA_ANGLE_X = 0.6194058656692505
CAM_RADIUS, SPH_RADIUS = 4.0, 0.95
SPLIT_SEED = {"train": 0, "val": 1, "test": 2}
# the mirror material of the renv images (tools/gen_env_dataset.py)
R_MATERIAL = dict(roughness=0.0, metallic=1.0, base_color=(0.8, 0.8, 0.8))


def sample_material(rng: np.random.Generator) -> dict:
    """A random material, draw for draw as ``tools/gen_env_dataset.py`` draws
    it at its defaults (``sph_loader.py:250-293``'s distributions)."""
    m = {"roughness": float(rng.uniform(0, 1.0) ** 2)}
    if rng.uniform() < 0.5:
        m["metallic"] = float(abs(rng.normal(0, 0.25)))
    else:
        m["metallic"] = float(1 - abs(rng.normal(0, 0.25)))
    m["metallic"] = float(np.clip(m["metallic"], 0, 1))
    base = rng.integers(170, 255, 3) if m["metallic"] >= 0.5 else rng.integers(50, 240, 3)
    m["color"] = (base / 255.0).tolist() + [1.0]
    return m


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    return np.where(x < 0.0031308, 12.92 * x, 1.055 * np.clip(x, 0, None) ** (1 / 2.4) - 0.055)


def _quantise(rgb: np.ndarray) -> np.ndarray:
    """Linear float32 radiance -> 8-bit sRGB, as the tool writes its PNGs."""
    return (np.clip(linear_to_srgb(rgb), 0, 1) * 255).astype(np.uint8)


class EnvSphereDataset:
    """One split: ``images`` uint8 [B, H, W, C], ``poses`` NGP c2w float32
    [B, 4, 4], ``intrinsics``, the per-frame ``env_index`` int32 [B],
    ``roughness`` and ``metallic`` float32 [B], ``color`` float32 [B, 4],
    ``r_images`` uint8 [B, H, W, 3] or None, ``env_images_names``."""

    def __init__(self, root: Optional[str] = None, split: str = "train", *,
                 scale: float = 0.8, offset=(0, 0, 0), with_renv: bool = False,
                 meta: Optional[dict] = None, images=None, r_images=None):
        self.root, self.split = root, split
        if meta is None:
            with open(os.path.join(root, f"transforms_{split}.json")) as f:
                meta = json.load(f)
        frames = meta["frames"]
        if images is None:
            images = np.stack(read_pngs([os.path.join(root, fr["file_path"]) for fr in frames]))
            renv = [fr for fr in frames if "renv_file_path" in fr] if with_renv else []
            r_images = (np.stack(read_pngs([os.path.join(root, fr["renv_file_path"])
                                            for fr in renv])) if renv else None)
        self.env_images_names = meta.get("env_images_names", [])
        name_to_idx = {n: i for i, n in enumerate(self.env_images_names)}
        self.images = images
        self.poses = np.stack([nerf_matrix_to_ngp(np.array(fr["transform_matrix"], np.float32),
                                                  scale=scale, offset=offset) for fr in frames])
        _, self.H, self.W, self.C = images.shape
        self.env_index = np.asarray([name_to_idx.get(fr.get("env_image_name", ""), 0)
                                     for fr in frames], np.int32)
        self.roughness = np.asarray([fr.get("roughness", 0.3) for fr in frames], np.float32)
        self.metallic = np.asarray([fr.get("metallic", 0.0) for fr in frames], np.float32)
        self.color = np.asarray([fr.get("color", [0.8, 0.8, 0.8, 1.0]) for fr in frames],
                                np.float32)
        self.r_images = r_images
        focal = self.W / (2 * np.tan(meta["camera_angle_x"] / 2))
        self.intrinsics = (focal, focal, self.W / 2, self.H / 2)
        self._dev = {}

    def __len__(self):
        return self.poses.shape[0]

    def material(self, i: int) -> dict:
        """Frame ``i``'s material as host scalars (an eval render's)."""
        return {"roughness": float(self.roughness[i]), "metallic": float(self.metallic[i]),
                "color": self.color[i].tolist()}

    def _cached(self, name: str, device, build):
        key = (name, str(torch.device(device)))
        if key not in self._dev:
            self._dev[key] = build().to(device)
        return self._dev[key]

    def device_images(self, device) -> torch.Tensor:
        """uint8 [B, H*W, C] on ``device``."""
        B = len(self)
        return self._cached("img", device, lambda: torch.from_numpy(
            np.ascontiguousarray(self.images.reshape(B, self.H * self.W, self.C))))

    def device_r_images(self, device) -> Optional[torch.Tensor]:
        """uint8 [B, H*W, 3] on ``device``, or None."""
        if self.r_images is None:
            return None
        B = len(self)
        return self._cached("rimg", device, lambda: torch.from_numpy(
            np.ascontiguousarray(self.r_images.reshape(B, self.H * self.W, -1))))

    def conditioning(self, device) -> torch.Tensor:
        """float32 [B, 6] on ``device``: roughness, metallic, colour (3), env
        index."""
        return self._cached("cond", device, lambda: torch.from_numpy(np.concatenate(
            [self.roughness[:, None], self.metallic[:, None], self.color[:, :3],
             self.env_index[:, None].astype(np.float32)], axis=1)))

    def epoch_order(self, rng: np.random.Generator, shuffle: bool = True):
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        return idx


class PrefilteredBank:
    """The :class:`PrefilteredEnv` of each envmap of a bank, each made on
    ``device`` the first time it is asked for (a split of a few frames
    prefilters only the envmaps it draws)."""

    def __init__(self, envs: np.ndarray, device=None):
        self.envs, self.device, self._pre = envs, resolve_device(device), {}

    def __len__(self):
        return len(self.envs)

    def __getitem__(self, i: int) -> PrefilteredEnv:
        if i not in self._pre:
            self._pre[i] = PrefilteredEnv(self.envs[i], self.device)
        return self._pre[i]


def generate_env_sphere(split: str = "train", n: Optional[int] = None, *, size: int = 400,
                        n_envs: int = 11, env_res: int = 64, scale: float = 0.8,
                        with_renv: bool = False, device=None,
                        prefiltered=None) -> EnvSphereDataset:
    """The first ``n`` frames of ``tools/gen_env_dataset.py``'s ``split``
    (default counts: train 1200, val and test 24; the tool's sphere radius,
    camera radius and seed), made in memory: the procedural bank of
    ``n_envs`` envmaps at ``env_res`` x ``2 env_res`` (prefiltered on
    ``device``, the card unless the CPU is asked for, as frames draw them,
    or ``prefiltered`` given: a :class:`PrefilteredBank` or a list), each
    frame rendered at ``size`` x ``size``."""
    if n is None:
        n = 1200 if split == "train" else 24
    if prefiltered is None:
        prefiltered = PrefilteredBank(make_env_bank(n_envs, H=env_res, W=2 * env_res), device)
    H = W = size
    focal = W / (2 * np.tan(CAMERA_ANGLE_X / 2))
    intr = (focal, focal, W / 2, H / 2)
    rng = np.random.default_rng(SPLIT_SEED[split])
    frames, images, r_images = [], [], []
    for _ in range(n):
        theta = rng.uniform(0, 360)
        phi = rng.uniform(-90, 90)
        env_idx = int(rng.integers(0, n_envs))
        mat = sample_material(rng)
        nerf_pose = pose_spherical(theta, phi, CAM_RADIUS)
        c2w = nerf_matrix_to_ngp(nerf_pose, scale=scale)
        img = render_pbr_sphere(prefiltered[env_idx], c2w, intr, H, W, radius=SPH_RADIUS,
                                roughness=mat["roughness"], metallic=mat["metallic"],
                                base_color=mat["color"][:3], bg=(0, 0, 0),
                                with_alpha=True).cpu().numpy()
        images.append(np.concatenate([_quantise(img[..., :3]),
                                      (img[..., 3:] * 255).astype(np.uint8)], -1))
        frame = {"transform_matrix": nerf_pose.tolist(), "env_image_name": f"env{env_idx}",
                 "roughness": mat["roughness"], "metallic": mat["metallic"],
                 "color": mat["color"]}
        if with_renv:
            rimg = render_pbr_sphere(prefiltered[env_idx], c2w, intr, H, W, radius=SPH_RADIUS,
                                     bg=(0, 0, 0), with_alpha=False, **R_MATERIAL)
            r_images.append(_quantise(rimg.cpu().numpy()))
        frames.append(frame)
    meta = {"camera_angle_x": CAMERA_ANGLE_X,
            "env_images_names": [f"env{i}" for i in range(n_envs)], "frames": frames}
    return EnvSphereDataset(None, split, scale=scale, meta=meta, images=np.stack(images),
                            r_images=np.stack(r_images) if with_renv else None)
