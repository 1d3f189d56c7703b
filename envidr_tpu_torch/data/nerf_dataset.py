"""NeRF-synthetic / colmap-style dataset (``transforms_*.json``).

Counterpart of ``envidr_tpu/data/nerf_dataset.py`` (``NeRFDataset``,
``interpolate_test_poses``, ``rand_poses``): the same pose convention
(``nerf_matrix_to_ngp``), intrinsics, splits and ``downscale`` /
``test_skip``.  Images are read by the port's own PNG decoder
(:mod:`envidr_tpu_torch.data.png`), all files of a split in one batched
decode.  The interface is that of
:class:`envidr_tpu_torch.data.synth_scene.SynthSpheres`, which
``Trainer.train_step`` reads: ``len``, ``images``, ``poses``,
``intrinsics``, ``H``, ``W``, ``C``, ``device_images(device)`` and
``epoch_order``.

``process_shard`` keeps this process's share of the frames,
``frames[rank::world]`` (the rank and world of ``torch.distributed`` when it
is initialised, else 0 and 1); ``fp16_preload`` puts the images on the
device as float16 already divided by their dtype's largest value, which the
trainer then leaves as they are.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from envidr_tpu_torch.data.png import pixel_max, read_png, read_pngs
from envidr_tpu_torch.geometry.rays import nerf_matrix_to_ngp


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
        return np.array([w, x, y, z])
    i = int(np.argmax(np.diag(R)))       # w ~ 0: the dominant diagonal axis
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2
    q = np.zeros(4)
    q[1 + i] = s / 4
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        return (1 - t) * q0 + t * q1
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_test_poses(pose0: np.ndarray, pose1: np.ndarray, n_test: int) -> np.ndarray:
    """A smooth slerped camera path of ``n_test + 1`` poses between two
    poses (provider.py:209-225)."""
    q0 = _quat_from_matrix(pose0[:3, :3])
    q1 = _quat_from_matrix(pose1[:3, :3])
    out = []
    for i in range(n_test + 1):
        ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = _quat_to_matrix(_slerp(q0, q1, ratio))
        pose[:3, 3] = (1 - ratio) * pose0[:3, 3] + ratio * pose1[:3, 3]
        out.append(pose)
    return np.stack(out)


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0.0, 2 * np.pi)) -> np.ndarray:
    """Random orbit-camera poses looking at the origin (provider.py:96-133)."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    centers = np.stack([radius * np.sin(thetas) * np.sin(phis),
                        radius * np.cos(thetas),
                        radius * np.sin(thetas) * np.cos(phis)], axis=-1)

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -normalize(centers)
    up = np.broadcast_to(np.array([0.0, -1.0, 0.0]), forward.shape)
    right = normalize(np.cross(forward, up))
    up = normalize(np.cross(right, forward))
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (size, 4, 4)).copy()
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses


def process_rank():
    """(rank, world) of ``torch.distributed``, or (0, 1) when it is not
    initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _image_path(root: str, frame: dict) -> str:
    path = os.path.join(root, frame["file_path"])
    return path if os.path.splitext(path)[1] else path + ".png"


def _rgb(img: np.ndarray) -> np.ndarray:
    """A grey image becomes three equal channels (``_load_image``)."""
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


class NeRFDataset:
    """One split on the host: ``images`` uint8 [B, H, W, C] (None for the
    slerped test path of a colmap capture), ``poses`` NGP c2w float32
    [B, 4, 4], ``intrinsics`` (fx, fy, cx, cy); ``mode`` is ``blender``
    (``transforms_{split}.json``) or ``colmap`` (one ``transforms.json``)."""

    def __init__(self, root: str, split: str = "train", *, scale: float = 0.33,
                 offset=(0, 0, 0), downscale: int = 1, test_skip: int = 1,
                 process_shard: bool = False, n_test: int = 10,
                 fp16_preload: bool = False):
        self.root, self.split = root, split
        self.fp16_preload = fp16_preload
        tpath = os.path.join(root, f"transforms_{split}.json")
        self.mode = "blender"
        if not os.path.exists(tpath):
            tpath = os.path.join(root, "transforms.json")   # a colmap capture
            self.mode = "colmap"
        with open(tpath) as f:
            meta = json.load(f)

        def ngp(frame):
            return nerf_matrix_to_ngp(np.array(frame["transform_matrix"], np.float32),
                                      scale=scale, offset=offset)

        frames = meta["frames"]
        if split != "train" and test_skip > 1:
            frames = frames[::test_skip]
        if self.mode == "colmap" and split == "test":
            # no held-out images: a slerped path between two random poses
            rng = np.random.default_rng(0)
            f0, f1 = rng.choice(frames, 2, replace=False)
            self.poses = interpolate_test_poses(ngp(f0), ngp(f1), n_test)
            self.images = None
            probe = _rgb(read_png(_image_path(root, frames[0])))[::downscale, ::downscale]
            self.H, self.W = probe.shape[:2]
            self.C = probe.shape[2]
            self._finish_intrinsics(meta, downscale)
            return
        if self.mode == "colmap":
            # the first frame is the validation view (provider.py:230)
            frames = (frames[1:] if split == "train"
                      else frames[:1] if split == "val" else frames)
        if process_shard:       # this process's frames (nerf_dataset.py:169-174)
            rank, world = process_rank()
            frames = frames[rank::world]
        images = read_pngs([_image_path(root, fr) for fr in frames])
        self.images = np.stack([_rgb(img)[::downscale, ::downscale] for img in images])
        self.poses = np.stack([ngp(fr) for fr in frames])
        _, self.H, self.W, self.C = self.images.shape
        self._finish_intrinsics(meta, downscale)

    def _finish_intrinsics(self, meta, downscale):
        """(fx, fy, cx, cy) at the loaded resolution (provider.py:240-268)."""
        H, W = self.H, self.W
        if "fl_x" in meta or "fl_y" in meta:
            fl_x = meta.get("fl_x", meta.get("fl_y")) / downscale
            fl_y = meta.get("fl_y", meta.get("fl_x")) / downscale
        elif "camera_angle_x" in meta or "camera_angle_y" in meta:
            fl_x = (W / (2 * np.tan(meta["camera_angle_x"] / 2))
                    if "camera_angle_x" in meta else None)
            fl_y = (H / (2 * np.tan(meta["camera_angle_y"] / 2))
                    if "camera_angle_y" in meta else fl_x)
            fl_x = fl_x if fl_x is not None else fl_y
        else:
            raise ValueError("no focal length in transforms json")
        # the json's cx/cy are at full resolution; the W/2 fallback is not
        cx = meta["cx"] / downscale if "cx" in meta else W / 2
        cy = meta["cy"] / downscale if "cy" in meta else H / 2
        self.intrinsics = (float(fl_x), float(fl_y), float(cx), float(cy))

    def __len__(self):
        return self.poses.shape[0]

    def device_images(self, device) -> torch.Tensor:
        """[B, H*W, C] on ``device``: the decoded dtype (uint8, or bool for
        1-bit grey; uint16 as int32, which torch's gather takes), or under
        ``fp16_preload`` float16 divided by the dtype's largest value
        (``provider.py:289-299``)."""
        B = self.images.shape[0]
        flat = torch.from_numpy(np.ascontiguousarray(
            self.images.reshape(B, self.H * self.W, self.C)))
        if self.fp16_preload:
            return (flat.float() / pixel_max(self.images.dtype)).half().to(device)
        if flat.dtype == torch.uint16:
            flat = flat.int()
        return flat.to(device)

    def epoch_order(self, rng: np.random.Generator, shuffle: bool = True):
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        return idx
