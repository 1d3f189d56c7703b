"""The port's scene data path against the JAX package and PIL: its own PNG
decoder (envidr_tpu_torch/data/png.py) byte for byte against PIL on views
of the tracked PNG scenes and on small PNGs of every supported colour type
and row filter; ``NeRFDataset`` against the JAX loader (blender and colmap
mode, downscale 1 and 4); ``mark_untrained`` on the synth_shiny3 train
poses; error-map sampling and its EMA given the same draws."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from envidr_tpu.data import nerf_dataset as jds
from envidr_tpu.geometry.rays import error_map_rays as jax_error_map_rays
from envidr_tpu.ops.grid import GridSpec as JaxGridSpec
from envidr_tpu.ops.grid import OccupancyGrid as JaxGrid
from envidr_tpu.ops.grid import mark_untrained as jax_mark_untrained
from envidr_tpu_torch.data import nerf_dataset as tds
from envidr_tpu_torch.data import png
from envidr_tpu_torch.geometry.rays import error_map_draws_to_rays, error_map_rays
from envidr_tpu_torch.ops.grid import GridSpec, init_grid, mark_untrained
from envidr_tpu_torch.train.trainer import update_error_row
from test_torch_helpers import ROOT

SCENES = ("synth_shiny", "synth_shiny2", "synth_shiny3")
RAY_ATOL = 1e-6       # f32 ray directions from equal pixels and poses
_DECODED = {}         # decoded datasets, once a process


def dataset(package: str, scene: str, split: str, **kw):
    key = (package, scene, split, tuple(sorted(kw.items())))
    if key not in _DECODED:
        cls = tds.NeRFDataset if package == "port" else jds.NeRFDataset
        _DECODED[key] = cls(os.path.join(ROOT, "data", scene), split, scale=0.8, **kw)
    return _DECODED[key]


# --- a small PNG encoder: every row filter, every supported colour type ---

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, ctype: int, filters, *, depth=8, interlace=0, idat_parts=2):
    """``img`` uint8 [H, W(, C)] as a PNG whose row ``y`` uses filter
    ``filters[y % len(filters)]``; the image data split over ``idat_parts``
    IDAT chunks."""
    H, W = img.shape[:2]
    bpp = png.CHANNELS.get(ctype, 1)
    pix = img.reshape(H, W * bpp).astype(np.int32)
    rows = []
    for y in range(H):
        cur = pix[y]
        prior = pix[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        f = filters[y % len(filters)]
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(rows))
    cut = len(data) // idat_parts
    parts = [data[i * cut:(i + 1) * cut if i < idat_parts - 1 else None]
             for i in range(idat_parts)]
    header = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", header) + b"".join(_chunk(b"IDAT", p) for p in parts)
            + _chunk(b"IEND", b""))


def _image(H, W, ctype, seed):
    """Noise beside smooth ramps, so that every predictor meets both."""
    rng = np.random.default_rng(seed)
    shape = (H, W) if ctype == 0 else (H, W, png.CHANNELS[ctype])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ramp = (np.add.outer(np.arange(H) * 7, np.arange(W) * 3) % 256).astype(np.uint8)
    img[: H // 2] = ramp[: H // 2].reshape((H // 2, W) + (1,) * (img.ndim - 2))
    return img


@pytest.mark.parametrize("scene", SCENES)
def test_decoder_matches_pil_on_tracked_views(scene):
    paths = [os.path.join(ROOT, "data", scene, p)
             for p in ("train/r_0.png", "train/r_7.png", "val/r_0.png", "test/r_1.png")]
    ours = png.read_pngs(paths)
    for path, img in zip(paths, ours):
        ref = np.asarray(Image.open(path))
        assert img.dtype == np.uint8 and img.shape == ref.shape == (400, 400, 4)
        np.testing.assert_array_equal(img, ref, err_msg=path)
    filters = np.concatenate([png.parse(open(p, "rb").read())[3][:, 0] for p in paths])
    assert {1, 4} <= set(filters.tolist())        # Sub and Paeth rows in the scenes


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_decoder_matches_pil_on_every_colour_type_and_filter(ctype, tmp_path):
    imgs, paths = [], []
    for i, (H, W, filters) in enumerate([(23, 17, [0, 1, 2, 3, 4]), (9, 31, [4, 3, 2, 1, 0]),
                                         (1, 1, [4]), (5, 2, [3, 4])]):
        img = _image(H, W, ctype, seed=ctype * 10 + i)
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(img, ctype, filters))
        ref = np.asarray(Image.open(path))
        np.testing.assert_array_equal(ref, img)         # the encoder is right
        np.testing.assert_array_equal(png.read_png(path), ref, err_msg=str((H, W, filters)))
        imgs.append(ref)
        paths.append(path)
    for got, ref in zip(png.read_pngs(paths + paths[:1]), imgs + imgs[:1]):   # batched
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced", "bad crc", "not a png"])
def test_decoder_refuses_every_other_kind(kind):
    """Malformed files: a palette image without PLTE, a 16-bit header over
    8-bit rows, an interlaced header over one pass's rows (the decoder reads
    each of these kinds when the file is whole, tests/test_torch_png_formats.py),
    a bad CRC and another format."""
    img = _image(4, 4, 2, seed=0)
    good = encode_png(img, 2, [0])
    data = {"palette": lambda: encode_png(img[..., 0], 3, [0]),
            "16-bit": lambda: encode_png(img, 2, [0], depth=16),
            "interlaced": lambda: encode_png(img, 2, [0], interlace=1),
            "bad crc": lambda: good[:-5] + b"\x00" + good[-4:],
            "not a png": lambda: b"GIF89a" + bytes(40)}[kind]()
    with pytest.raises(png.PNGError):
        png.decode(data)


@pytest.mark.parametrize("downscale", [1, 4])
def test_nerf_dataset_blender_matches_jax_loader(downscale):
    for split, skip in (("val", 1), ("test", 2)):
        ref = dataset("jax", "synth_shiny3", split, downscale=downscale, test_skip=skip)
        ours = dataset("port", "synth_shiny3", split, downscale=downscale, test_skip=skip)
        assert ours.mode == ref.mode == "blender"
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.poses, ref.poses)
        assert ours.intrinsics == ref.intrinsics
        assert (len(ours), ours.H, ours.W, ours.C) == (len(ref), ref.H, ref.W, ref.C)
        assert ours.H == 400 // downscale
        flat = ours.device_images("cpu")
        assert flat.dtype == torch.uint8 and tuple(flat.shape) == (len(ours), ours.H * ours.W, 4)
        np.testing.assert_array_equal(ours.epoch_order(np.random.default_rng(3)),
                                      ref.epoch_order(np.random.default_rng(3)))


def _colmap_capture(root):
    """Five frames of one transforms.json with fl_x/fl_y/cx/cy, RGB and one grey
    (the loader repeats its channel three times)."""
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(4)
    frames = []
    for i in range(5):
        img = rng.integers(0, 256, (24, 32) if i == 2 else (24, 32, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.png"))
        theta = 0.4 * i
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                        [-np.sin(theta), 0, np.cos(theta)]]
        pose[:3, 3] = [2.0 * np.sin(theta), 0.3, 2.0 * np.cos(theta)]
        frames.append({"file_path": f"images/{i}", "transform_matrix": pose.tolist()})
    meta = {"fl_x": 30.0, "fl_y": 31.0, "cx": 16.5, "cy": 11.5, "frames": frames}
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("downscale", [1, 4])
def test_nerf_dataset_colmap_matches_jax_loader(downscale, tmp_path):
    _colmap_capture(str(tmp_path))
    for split in ("train", "val", "test"):
        ref = jds.NeRFDataset(str(tmp_path), split, scale=0.5, downscale=downscale, n_test=6)
        ours = tds.NeRFDataset(str(tmp_path), split, scale=0.5, downscale=downscale, n_test=6)
        assert ours.mode == ref.mode == "colmap"
        if split == "test":                  # a slerped path, no images
            assert ours.images is None and ref.images is None and len(ours) == 7
        else:
            np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_allclose(ours.poses, ref.poses, rtol=0, atol=1e-6)
        assert ours.intrinsics == ref.intrinsics
        assert (ours.H, ours.W, ours.C) == (ref.H, ref.W, ref.C)


def test_pose_helpers_match_jax():
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(tds.rand_poses(rng_a, 7, radius=2.0),
                                  jds.rand_poses(rng_b, 7, radius=2.0))
    poses = dataset("port", "synth_shiny3", "test").poses
    np.testing.assert_allclose(tds.interpolate_test_poses(poses[0], poses[3], 9),
                               jds.interpolate_test_poses(poses[0], poses[3], 9), rtol=0, atol=0)
    # process_shard with no process group: rank 0 of 1 keeps every frame, as
    # the JAX loader's does in one process (the world-2 case:
    # tests/test_torch_parallel.py)
    root = os.path.join(ROOT, "data", "synth_shiny3")
    ours = tds.NeRFDataset(root, "val", scale=0.8, downscale=4, process_shard=True)
    ref = jds.NeRFDataset(root, "val", scale=0.8, downscale=4, process_shard=True)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.poses, ref.poses)


def test_mark_untrained_matches_jax_on_the_shiny3_train_poses():
    train = dataset("port", "synth_shiny3", "train", downscale=4)
    spec = GridSpec(grid_size=128, bound=1.0)
    density = np.random.default_rng(6).uniform(0, 1, (1, 128 ** 3)).astype(np.float32)
    grid = init_grid(spec)._replace(density=torch.from_numpy(density))
    ours = mark_untrained(grid, spec, train.poses, train.intrinsics).density.numpy()
    jgrid = JaxGrid(jnp.asarray(density), jnp.zeros((1, 128 ** 3), bool), jnp.float32(0), 0)
    ref = np.asarray(jax_mark_untrained(jgrid, JaxGridSpec(grid_size=128, bound=1.0),
                                        jnp.asarray(train.poses), train.intrinsics).density)
    np.testing.assert_array_equal(ours, ref)
    unseen = (ours < 0).mean()
    assert 0.0 < unseen < 0.5
    np.testing.assert_array_equal(ours[ours >= 0], density[ours >= 0])


def test_error_map_rays_match_jax_given_the_same_draws():
    """JAX's draws (categorical cell, two uniform offsets) made from its keys
    as ``error_map_rays`` splits them, through the port's pixel and ray
    arithmetic; a map with a few hot cells, so that cells repeat."""
    val = dataset("port", "synth_shiny3", "val", downscale=4)
    em = np.full((1, 128 * 128), 1e-5, np.float32)
    em[0, [5, 130, 8000, 16383]] = [3.0, 1.0, 2.0, 0.5]
    key = jax.random.PRNGKey(7)
    ref = jax_error_map_rays(key, jnp.asarray(val.poses[:1]), val.intrinsics, val.H, val.W,
                             256, jnp.asarray(em))
    k1, k2, k3 = jax.random.split(key, 3)
    ic = jax.random.categorical(k1, jnp.log(jnp.clip(jnp.asarray(em), 1e-12))[:, None, :],
                                axis=-1, shape=(1, 256))
    fx_r, fy_r = jax.random.uniform(k2, (1, 256)), jax.random.uniform(k3, (1, 256))
    ours = error_map_draws_to_rays(torch.from_numpy(val.poses[:1]), val.intrinsics, val.H, val.W,
                                   *(torch.from_numpy(np.asarray(a)) for a in (ic, fx_r, fy_r)))
    np.testing.assert_array_equal(ours["inds_coarse"].numpy(), np.asarray(ref["inds_coarse"]))
    np.testing.assert_array_equal(ours["inds"].numpy(), np.asarray(ref["inds"]))
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=0, atol=RAY_ATOL)
    assert len(np.unique(np.asarray(ic))) < 32


def test_error_map_sampling_follows_the_map():
    """torch.multinomial draws cells in proportion to their error."""
    em = torch.full((1, 128 * 128), 0.0)
    em[0, 77], em[0, 9001] = 3.0, 1.0
    g = torch.Generator().manual_seed(0)
    rays = error_map_rays(g, torch.eye(4)[None], (10.0, 10.0, 50.0, 50.0), 100, 100, 4000, em)
    ic = rays["inds_coarse"][0]
    assert set(ic.tolist()) == {77, 9001}
    assert abs(float((ic == 77).float().mean()) - 0.75) < 0.03
    assert int(rays["inds"].max()) < 100 * 100


def test_error_map_ema_matches_jax_with_duplicates():
    """The step's EMA ``row.at[ic].set(0.9 * row[ic] + 0.1 * err)`` with many
    rays a cell: the JAX scatter on the CPU lets the last ray win, and so does
    the port's rule."""
    rng = np.random.default_rng(8)
    row = rng.uniform(0.01, 0.3, 128 * 128).astype(np.float32)
    ic = rng.integers(0, 50, 4096)
    err = rng.uniform(0, 1, 4096).astype(np.float32)
    ref = jnp.asarray(row).at[ic].set(0.9 * jnp.take(jnp.asarray(row), ic) + 0.1 * err)
    ours = update_error_row(torch.from_numpy(row), torch.from_numpy(ic), torch.from_numpy(err))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    last = {c: i for i, c in enumerate(ic)}
    c = int(ic[0])
    assert ours[c] == np.float32(0.9 * row[c] + 0.1 * err[last[c]])
