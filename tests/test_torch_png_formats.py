"""The port's PNG decoder (envidr_tpu_torch/data/png.py) on every PNG kind
beyond 8-bit non-interlaced colour types 0/2/4/6, against
``imageio.v2.imread`` (what the JAX loader reads with): 16-bit grey, RGB,
grey + alpha and RGBA, 1/2/4-bit grey, palettes of 1 to 8 bits with and
without ``tRNS``, and the Adam7-interlaced version of each.  The files are
written by PIL where it writes the kind (16-bit grey, 1-bit grey, palettes)
and by the small encoder below otherwise (PIL writes no 16-bit colour, no
2/4-bit grey and no interlacing), every row filter used.  Then
``NeRFDataset`` on a 16-bit scene against the JAX loader, and the one place
where the two packages then differ: the JAX step divides any integer pixel
by 255, the port by the dtype's largest value."""

import json
import os
import struct
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from envidr_tpu.data import nerf_dataset as jds
from envidr_tpu_torch.data import nerf_dataset as tds
from envidr_tpu_torch.data import png

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
SHAPES = [(1, 1), (3, 5), (9, 13), (17, 8)]     # Adam7 passes empty and full


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples, depth):
    """[h, w, C] samples -> [h, row bytes] uint8 (big-endian, sub-byte high
    bits first)."""
    h = samples.shape[0]
    a = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return a.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return a.astype(np.uint8)
    per = 8 // depth
    a = np.concatenate([a, np.zeros((h, -a.shape[1] % per), np.int64)], 1).reshape(h, -1, per)
    return (a << (np.arange(per - 1, -1, -1) * depth)).sum(-1).astype(np.uint8)


def _filtered(rows, bpp, filters):
    out = []
    for y, cur in enumerate(rows.astype(np.int32)):
        prior = rows[y - 1].astype(np.int32) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        f = filters[y % len(filters)]
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][f]
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def encode(samples, depth, ctype, *, interlace=0, filters=(0, 1, 2, 3, 4), palette=None,
           trns=None) -> bytes:
    """A PNG of ``samples`` [H, W(, C)] at ``depth`` bits, each pass's rows
    filtered in turn by ``filters``."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    H, W, C = s.shape
    bpp = max(1, C * depth // 8)
    passes = [s[y0::dy, x0::dx] for y0, x0, dy, dx in ADAM7] if interlace else [s]
    raw = b"".join(_filtered(_pack(p, depth), bpp, filters) for p in passes
                   if p.shape[0] and p.shape[1])
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return (png.SIGNATURE + body + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _assert_same_as_imageio(path):
    ref = imageio.imread(path)
    ours = png.read_png(path)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, (ours.dtype, ours.shape,
                                                                 ref.dtype, ref.shape)
    np.testing.assert_array_equal(ours, ref)
    return ref


KINDS = {        # name -> (colour type, bit depth)
    "grey16": (0, 16), "rgb16": (2, 16), "grey_alpha16": (4, 16), "rgba16": (6, 16),
    "grey1": (0, 1), "grey2": (0, 2), "grey4": (0, 4),
    "palette1": (3, 1), "palette2": (3, 2), "palette4": (3, 4), "palette8": (3, 8),
}


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decoder_matches_imageio(kind, interlace, tmp_path):
    ctype, depth = KINDS[kind]
    rng = np.random.default_rng(depth * 10 + ctype)
    paths, refs = [], []
    for i, (H, W) in enumerate(SHAPES):
        samples = rng.integers(0, 2**depth, (H, W, png.CHANNELS[ctype]))
        variants = [dict()]
        if ctype == 3:       # a palette short of 2^depth (an index past it reads black)
            n = int(rng.integers(1, 2**depth + 1))
            pal = rng.integers(0, 256, (n, 3))
            variants = [dict(palette=pal), dict(palette=pal, trns=bytes([0, 7, 255][:n]))]
        for j, extra in enumerate(variants):
            path = str(tmp_path / f"{i}_{j}.png")
            with open(path, "wb") as f:
                f.write(encode(samples, depth, ctype, interlace=interlace,
                               filters=[(i + y) % 5 for y in range(5)], **extra))
            refs.append(_assert_same_as_imageio(path))
            paths.append(path)
    for got, ref in zip(png.read_pngs(paths + paths[:1]), refs + refs[:1]):     # batched
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


PIL_KINDS = {"I;16": None, "1": None, "P1": 1, "P2": 2, "P4": 4, "P8": 8}


@pytest.mark.parametrize("transparency", [False, True])
@pytest.mark.parametrize("mode", sorted(PIL_KINDS))
def test_decoder_matches_imageio_on_pil_files(mode, transparency, tmp_path):
    rng = np.random.default_rng(len(mode))
    path = str(tmp_path / "pil.png")
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, (13, 21)).astype(np.uint16))
    elif mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (13, 21)).astype(bool))
    else:
        bits = PIL_KINDS[mode]
        img = Image.fromarray(rng.integers(0, 2**bits, (13, 21)).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 3 * 2**bits).astype(np.uint8).tolist())
    kw = {"bits": PIL_KINDS[mode]} if mode.startswith("P") else {}
    if transparency:
        kw["transparency"] = 4097 if mode == "I;16" else 1
    img.save(path, **kw)
    _assert_same_as_imageio(path)


def _grey16_scene(root, n=2, H=16, W=16):
    """A blender-layout scene of 16-bit grey views."""
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(root, "train"))
    frames = []
    for k in range(n):
        Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(
            os.path.join(root, "train", f"r_{k}.png"))
        pose = np.eye(4)
        pose[:3, 3] = [0.0, 0.0, 2.5 + 0.1 * k]
        frames.append({"file_path": f"train/r_{k}", "transform_matrix": pose.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def _tiny_density_options(load):
    """A density field with a frequency encoding: the smallest JAX step."""
    return load("", path="/none", workspace="/none", num_rays=16, max_steps=128,
                early_stop_steps=8, iters=100, encoding_pos="frequency", use_sdf=False,
                hidden_dim=8, hidden_dim_color=8, hidden_dim_env=8, num_layers=2,
                num_layers_color=2, samples_budget=8, use_env_net=False, use_diffuse=False)


def test_16bit_scene_loads_as_jax_and_trains_on_unit_pixels(tmp_path):
    """JAX's loader and the port's read a 16-bit grey scene alike (uint16,
    grey repeated to RGB).  Training on it, the JAX step divides each pixel
    by 255 (``trainer.py:437-440``: targets up to 257, its colour term
    ~2.5e4 here) and the port by 65535 (targets in [0, 1], colour term below
    1): ROADMAP's "Known divergences"."""
    from envidr_tpu.config import load_options as jax_load
    from envidr_tpu.config import network_config as jax_netcfg
    from envidr_tpu.train.schedules import resolve as jax_resolve
    from envidr_tpu.train.trainer import Trainer as JaxTrainer
    from envidr_tpu_torch.config import load_options, network_config
    from envidr_tpu_torch.train.trainer import Trainer

    _grey16_scene(str(tmp_path))
    ref = jds.NeRFDataset(str(tmp_path), "train", scale=0.8)
    ours = tds.NeRFDataset(str(tmp_path), "train", scale=0.8)
    assert ours.images.dtype == ref.images.dtype == np.uint16
    np.testing.assert_array_equal(ours.images, ref.images)
    assert ours.images.shape == (2, 16, 16, 3) and ours.intrinsics == ref.intrinsics

    jopt = _tiny_density_options(jax_load)
    jtr = JaxTrainer(jopt, jax_netcfg(jopt), workspace=str(tmp_path / "jax"))
    sched = jax_resolve(jopt, 1, 0)
    jtr._sched = sched
    jtr.update_extra_state()
    step = jtr._get_train_step(sched, jtr.sample_budget(sched), 16, 16, 16, 3, "scene")
    batch = {"pose": jnp.asarray(ref.poses[0]), "image": jnp.asarray(ref.images[0].reshape(-1, 3)),
             "intrinsics": jnp.asarray(ref.intrinsics, jnp.float32)}
    _, jm = step(jtr.state, batch, jax.random.PRNGKey(1),
                 {k: jnp.asarray(v) for k, v in sched.weights.items()})

    topt = _tiny_density_options(load_options)
    tr = Trainer(topt, network_config(topt), device="cpu")
    top = tr._pixels(torch.full((1, 3), 65535, dtype=torch.int32), 65535)
    assert float(top.max()) == 1.0                      # JAX's would read 65535 / 255 = 257
    m = tr.train_step(ours)
    assert float(jm["color"]) > 1e3 and float(m["color"]) < 1.0, (float(jm["color"]),
                                                                  float(m["color"]))
