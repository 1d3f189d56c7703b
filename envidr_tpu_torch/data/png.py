"""A PNG decoder and writer of the port's own: the standard library's
``zlib`` and numpy.

The JAX package reads images through imageio or PIL
(``envidr_tpu/data/nerf_dataset.py:_load_image``); the card machine has
neither.  This decoder reads what the tracked scenes hold and what a NeRF
capture usually holds: 8-bit, non-interlaced PNGs of colour type 0 (grey),
2 (RGB), 4 (grey + alpha) or 6 (RGBA), with any of the five row filters.
Every other kind (palette, 16-bit, interlaced) raises.

Unfiltering is sequential along a row (Sub, Average and Paeth read the
pixel decoded to the left) and down the columns (Up, Average and Paeth read
the row above).  A pixel needs only its left, upper and upper-left
neighbours, so every pixel of one anti-diagonal ``y + x = d`` can be decoded
at once from the diagonals before it: :func:`_unfilter` stores the image
skewed (diagonal ``d`` is one column) and takes ``H + W - 1`` vector steps
over all images of a batch and all channels, instead of ``H * W`` pixel
steps.

:func:`write_png` writes 8-bit images of colour type 0, 2, 4 or 6, every row
with filter 0 (None): what the apps and the eval dumps write.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples per pixel
BATCH_BYTES = 64 << 20                  # skewed int16 working set of one batch


class PNGError(ValueError):
    pass


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PNGError("truncated PNG (no IEND)")


def parse(data: bytes) -> Tuple[int, int, int, np.ndarray]:
    """(H, W, colour type, filtered rows uint8 [H, 1 + W * channels])."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    W, H, depth, ctype, compression, filt, interlace = header
    if ctype not in CHANNELS:
        raise PNGError(f"colour type {ctype} is not supported (0, 2, 4 and 6 are)")
    if depth != 8:
        raise PNGError(f"bit depth {depth} is not supported (8 is)")
    if interlace != 0:
        raise PNGError("interlaced PNGs are not supported")
    if compression != 0 or filt != 0:
        raise PNGError(f"unknown compression {compression} or filter method {filt}")
    stride = 1 + W * CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * stride:
        raise PNGError(f"image data holds {raw.size} bytes, expected {H * stride}")
    rows = raw.reshape(H, stride)
    if rows[:, 0].max(initial=0) > 4:
        raise PNGError(f"unknown row filter {int(rows[:, 0].max())}")
    return H, W, ctype, rows


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered rows uint8 [B, H, 1 + W * bpp] -> pixels uint8 [B, H, W, bpp].

    Pixel (y, x) lies in column ``d + 2`` of row ``y + 1`` of the skewed
    array ``S`` (``d = y + x``); row 0 and columns 0-1 are the zeros the
    filters read outside the image.  Its left neighbour is then
    ``S[y + 1, d + 1]``, the one above ``S[y, d + 1]`` and the upper-left one
    ``S[y, d]``, and a diagonal's rows form one contiguous range."""
    B, H, stride = rows.shape
    W = (stride - 1) // bpp
    ftype = rows[:, :, 0].astype(np.int16)[..., None]             # [B, H, 1]
    raw = rows[:, :, 1:].reshape(B, H, W, bpp).astype(np.int16)
    D = H + W - 1
    R = np.zeros((B, H, D, bpp), np.int16)                        # raw, skewed
    for y in range(H):
        R[:, y, y:y + W] = raw[:, y]
    S = np.zeros((B, H + 1, D + 2, bpp), np.int16)
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H - 1, d)
        a = S[:, y0 + 1:y1 + 2, d + 1]
        b = S[:, y0:y1 + 1, d + 1]
        c = S[:, y0:y1 + 1, d]
        ft = ftype[:, y0:y1 + 1]
        pred = np.where(ft == 1, a, 0)
        pred = np.where(ft == 2, b, pred)
        pred = np.where(ft == 3, (a + b) >> 1, pred)
        if (ft == 4).any():
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(ft == 4, paeth, pred)
        S[:, y0 + 1:y1 + 2, d + 2] = (R[:, y0:y1 + 1, d] + pred) & 255
    out = np.empty((B, H, W, bpp), np.uint8)
    for y in range(H):
        out[:, y] = S[:, y + 1, y + 2:y + 2 + W]
    return out


def _as_image(pixels: np.ndarray, ctype: int) -> np.ndarray:
    """[..., H, W, bpp] -> grey images as [..., H, W], as imageio and PIL
    return them; the others keep their channels."""
    return pixels[..., 0] if ctype == 0 else pixels


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (grey) or [H, W, C] (C = 2, 3 or 4)."""
    H, W, ctype, rows = parse(data)
    return _as_image(_unfilter(rows[None], CHANNELS[ctype])[0], ctype)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode several files, those of one size and colour type together in
    batches of at most ``BATCH_BYTES`` of working set; the images in the
    order of ``paths``."""
    parsed = []
    for path in paths:
        with open(path, "rb") as f:
            parsed.append(parse(f.read()))
    out: List[np.ndarray] = [None] * len(parsed)
    groups = {}
    for i, (H, W, ctype, _) in enumerate(parsed):
        groups.setdefault((H, W, ctype), []).append(i)
    for (H, W, ctype), idx in groups.items():
        bpp = CHANNELS[ctype]
        per_image = 2 * (H + 1) * (H + W + 1) * bpp * 2
        step = max(1, BATCH_BYTES // per_image)
        for s in range(0, len(idx), step):
            part = idx[s:s + step]
            pixels = _unfilter(np.stack([parsed[i][3] for i in part]), bpp)
            for i, img in zip(part, pixels):
                out[i] = _as_image(img, ctype)
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1, 2, 3 or 4) -> PNG bytes of colour
    type 0, 4, 2 or 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PNGError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise PNGError(f"write_png takes [H, W] or [H, W, 1|2|3|4], not {img.shape}")
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(H, W * C)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    """Write ``img`` (as :func:`encode` takes it) to ``path``; returns the path."""
    with open(path, "wb") as f:
        f.write(encode(img))
    return path
