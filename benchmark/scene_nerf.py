"""A NeRF-synthetic scene read from its files (``transforms_<split>.json``
and its RGBA PNGs), for the cells that train on a tracked scene rather than
on ``scene.py``'s procedural spheres.

:class:`NerfScene` offers what ``scene.SceneSplit`` offers, the arrays the
program's ``Trainer.train_step`` reads and the reference reads as the same
arrays: ``images`` uint8 [B, H, W, 4], ``poses`` float32 [B, 4, 4] (the
NeRF c2w in the NGP convention at ``scale``, ``scene._to_ngp``),
``intrinsics`` (fx, fy, cx, cy) from ``camera_angle_x`` at the loaded
resolution, ``H``, ``W``, ``C``, ``device_images`` and ``epoch_order``.
``downscale`` keeps every ``downscale``-th pixel of each row and column
(CPU tests).  The PNGs are decoded by the program's own decoder
(``envidr_tpu_torch/data/png.py``): the card machine has no other, and
both sides of a comparison read the same decoded arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.scene import _to_ngp


class NerfScene:
    def __init__(self, root: str, split: str, scale: float, downscale: int = 1):
        from envidr_tpu_torch.data.png import read_pngs

        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        frames = meta["frames"]
        paths = [os.path.join(root, fr["file_path"]) for fr in frames]
        paths = [p if os.path.splitext(p)[1] else p + ".png" for p in paths]
        images = [img[::downscale, ::downscale] for img in read_pngs(paths)]
        if any(img.ndim != 3 or img.shape[-1] != 4 or img.dtype != np.uint8 for img in images):
            raise ValueError(f"{root}: the cells read 8-bit RGBA views")
        self.images = np.stack(images)
        self.poses = np.stack([_to_ngp(np.array(fr["transform_matrix"], np.float32), scale)
                               for fr in frames])
        _, self.H, self.W, self.C = self.images.shape
        fl = self.W / (2 * np.tan(meta["camera_angle_x"] / 2))
        self.intrinsics = (float(fl), float(fl), self.W / 2, self.H / 2)

    def __len__(self):
        return self.poses.shape[0]

    def device_images(self, device) -> torch.Tensor:
        """uint8 [B, H*W, C] on ``device``."""
        return torch.from_numpy(self.images.reshape(len(self), self.H * self.W, self.C)).to(device)

    def epoch_order(self, rng: np.random.Generator):
        idx = np.arange(len(self))
        rng.shuffle(idx)
        return idx
