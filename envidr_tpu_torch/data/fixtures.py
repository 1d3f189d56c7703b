"""The seeded sphere dataset on disk, with its canonical arguments.

Counterpart of ``envidr_tpu/data/fixtures.py``.  The committed quality
checkpoints (``assets/neus_cp_long_best.ckpt``) were trained on the scene of
``tools/gen_synth_scene.py`` at 400 px and 50 train views; a set made at
another size would hold those checkpoints to the wrong pictures.
:func:`ensure_synth_spheres` writes that scene where it is missing, in the
generator's layout (``{train,val,test}/r_{k}.png`` and
``transforms_{split}.json`` with ``camera_angle_x`` and each frame's
``file_path`` and ``transform_matrix``), from the port's own renderer
(:mod:`envidr_tpu_torch.data.synth_scene`) and PNG writer; a set that is
there is checked for its resolution with the port's decoder.
"""

from __future__ import annotations

import json
import os

import numpy as np

from envidr_tpu_torch.data.png import read_png, write_png
from envidr_tpu_torch.data.synth_scene import SPLITS, render, split_poses

CANONICAL_SIZE = 400
CANONICAL_N_TRAIN = 50


def write_split(out: str, split: str, n: int, size: int, seed: int):
    """One split as ``write_split`` of ``tools/gen_synth_scene.py`` writes it."""
    focal = size * 1.25
    os.makedirs(os.path.join(out, split), exist_ok=True)
    frames = []
    for k, c2w in enumerate(split_poses(n, seed)):
        fp = f"{split}/r_{k}.png"
        write_png(os.path.join(out, fp), render(c2w, size, size, focal))
        frames.append({"file_path": fp, "transform_matrix": c2w.tolist()})
    camera_angle_x = 2 * np.arctan(size / (2 * focal))
    with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)


def ensure_synth_spheres(data_dir: str, size: int = CANONICAL_SIZE,
                         n_train: int = CANONICAL_N_TRAIN) -> str:
    """Write the sphere scene to ``data_dir`` if it has no
    ``transforms_val.json`` (``n_train`` train views, the generator's 5 val
    and 5 test views, ``size`` px); then check that its first val view is
    ``size`` px high.  Returns ``data_dir``; raises RuntimeError on a set of
    another resolution (delete the directory to regenerate)."""
    tval = os.path.join(data_dir, "transforms_val.json")
    if not os.path.exists(tval):
        for split in ("train", "val", "test"):
            n_default, seed = SPLITS[split]
            write_split(data_dir, split, n_train if split == "train" else n_default, size, seed)
    with open(tval) as f:
        meta = json.load(f)
    img_path = os.path.join(data_dir, meta["frames"][0]["file_path"])
    if not os.path.splitext(img_path)[1]:
        img_path += ".png"
    if os.path.exists(img_path):
        h = read_png(img_path).shape[0]
        if h != size:
            raise RuntimeError(
                f"{data_dir} exists at resolution {h}px but {size}px was "
                f"requested — delete the directory to regenerate with the "
                f"canonical args (size={size}, n_train={n_train}).")
    return data_dir
