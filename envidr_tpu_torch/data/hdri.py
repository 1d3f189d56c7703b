"""User-supplied HDRI ingestion (counterpart of ``envidr_tpu/data/hdri.py``).

Builds an env bank from local lat-long environment maps instead of the
procedural one:

  * ``.hdr``  Radiance RGBE, parsed in plain numpy (flat and adaptive RLE)
  * ``.npy`` / ``.npz``  raw [H, W, 3] float arrays

``.exr``, ``.png`` and ``.jpg`` need an image library, which the port does not
use: they raise, as the JAX package raises without imageio.

    bank = build_env_bank_from_dir("my_hdris/", H=64, W=128)
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def read_radiance_hdr(path: str) -> np.ndarray:
    """Parse a Radiance RGBE ``.hdr`` file -> [H, W, 3] float32 radiance."""
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    exposure = 1.0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    pos = eol + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {dims}")
    H, W = int(dims[1]), int(dims[3])

    # ---- pixels ----
    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((H, W, 4), np.uint8)
    o = 0
    for y in range(H):
        if W < 8 or W > 0x7FFF or not (buf[o] == 2 and buf[o + 1] == 2):
            # flat (possibly old-style RLE — not emitted by modern tools)
            row = buf[o:o + W * 4].reshape(W, 4)
            rgbe[y] = row
            o += W * 4
            continue
        assert (int(buf[o + 2]) << 8 | int(buf[o + 3])) == W, "scanline width"
        o += 4
        for ch in range(4):  # adaptive RLE per channel
            x = 0
            while x < W:
                count = int(buf[o])
                if count == 0:
                    raise ValueError(
                        f".hdr RLE parse error: zero count at scanline {y}")
                if count > 128:          # run
                    rgbe[y, x:x + count - 128, ch] = buf[o + 1]
                    x += count - 128
                    o += 2
                else:                    # literal
                    rgbe[y, x:x + count, ch] = buf[o + 1:o + 1 + count]
                    x += count
                    o += 1 + count
    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (mant + 0.5) * scale[..., None] / exposure


def load_envmap(path: str) -> np.ndarray:
    """Load one lat-long environment map -> [H, W, 3] float32 linear."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_radiance_hdr(path)
    if ext == ".npy":
        return np.asarray(np.load(path), np.float32)[..., :3]
    if ext == ".npz":
        z = np.load(path)
        return np.asarray(z[list(z.keys())[0]], np.float32)[..., :3]
    if ext in (".exr", ".png", ".jpg", ".jpeg"):
        # the JAX package reads these through imageio, which the port does
        # not use; without it JAX raises as well
        raise RuntimeError(f"{path}: {ext} envmaps need an image library the port "
                           "does not use; convert to .hdr or .npy")
    raise ValueError(f"{path}: unsupported envmap format {ext}")


def resize_latlong(env: np.ndarray, H: int, W: int) -> np.ndarray:
    """Area-ish downsample / bilinear upsample of a lat-long map."""
    h, w, _ = env.shape
    if h == H and w == W:
        return env
    if h % H == 0 and w % W == 0:   # exact box filter (energy preserving)
        return env.reshape(H, h // H, W, w // W, 3).mean((1, 3))
    ys = np.clip((np.arange(H) + 0.5) * h / H - 0.5, 0, h - 1)
    xs = (np.arange(W) + 0.5) * w / W - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int) % w
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = (x0 + 1) % w               # longitude wraps
    fy = (ys - y0)[:, None, None]
    fx = (xs - np.floor(xs))[None, :, None]
    return ((env[y0][:, x0] * (1 - fx) + env[y0][:, x1] * fx) * (1 - fy)
            + (env[y1][:, x0] * (1 - fx) + env[y1][:, x1] * fx) * fy)


def build_env_bank_from_dir(
    hdri_dir: str, H: int = 64, W: int = 128,
    exts=(".hdr", ".exr", ".npy", ".npz", ".png", ".jpg"),
    intensity_scale: float = 1.0,
    paths: Optional[List[str]] = None,
) -> np.ndarray:
    """All env maps in a directory (sorted) -> bank [N, H, W, 3] float32.

    The procedural bank (:func:`envidr_tpu_torch.render.pbr.make_env_bank`)
    remains the fallback.
    """
    if paths is None:
        paths = sorted(
            os.path.join(hdri_dir, f) for f in os.listdir(hdri_dir)
            if os.path.splitext(f)[1].lower() in exts)
    if not paths:
        raise FileNotFoundError(f"no envmaps ({'/'.join(exts)}) in {hdri_dir}")
    bank = [resize_latlong(load_envmap(p), H, W) * intensity_scale
            for p in paths]
    return np.stack(bank).astype(np.float32)
