"""A PNG decoder and writer of the port's own: the standard library's
``zlib`` and numpy.

The JAX package reads images through imageio or PIL
(``envidr_tpu/data/nerf_dataset.py:_load_image``); the card machine has
neither.  This decoder reads every standard PNG and returns what
``imageio.v2.imread`` (its pillow plugin) returns for it:

  * colour types 0 (grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA) at 8 bits
    as uint8 ``[H, W]`` (grey) or ``[H, W, C]``;
  * grey at 16 bits as uint16 ``[H, W]`` (big-endian samples); RGB and RGBA
    at 16 bits as uint8, the high byte of each sample; grey + alpha at 16
    bits as uint8 RGBA (the grey's high byte three times, then the alpha's);
  * grey at 1 bit as bool, at 2 and 4 bits as uint8 scaled to 0-255 (each
    level times 85 or 17);
  * palette images (type 3, 1 to 8 bits) as uint8 RGB through ``PLTE``;
    an index past the palette's end reads black, and ``tRNS`` is ignored
    (pillow keeps it aside, and imageio converts to the palette's RGB mode);
  * Adam7-interlaced images of all of these: each of the seven passes is
    unfiltered as an image of its own, then scattered to its pixels.

Unfiltering is sequential along a row (Sub, Average and Paeth read the
pixel decoded to the left) and down the columns (Up, Average and Paeth read
the row above).  A pixel needs only its left, upper and upper-left
neighbours, so every pixel of one anti-diagonal ``y + x = d`` can be decoded
at once from the diagonals before it: :func:`_unfilter` stores the image
skewed (diagonal ``d`` is one column) and takes ``H + W - 1`` vector steps
over all images of a batch and all channels, instead of ``H * W`` pixel
steps.  The filters' "pixel" is ``ceil(bits per pixel / 8)`` bytes: one
byte below 8 bits, two bytes a sample at 16.

:func:`write_png` writes 8-bit images of colour type 0, 2, 4 or 6, every row
with filter 0 (None): what the apps and the eval dumps write.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # colour type -> samples per pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
BATCH_BYTES = 64 << 20                  # skewed int16 working set of one batch


class PNGError(ValueError):
    pass


class Parsed(NamedTuple):
    """A PNG's header and its filtered image data: ``rows`` uint8
    ``[H, 1 + row bytes]``, or for an interlaced file a tuple of the seven
    passes' rows (``None`` for a pass with no pixels)."""

    H: int
    W: int
    ctype: int
    rows: object
    depth: int
    interlace: int
    palette: Optional[np.ndarray]       # uint8 [256, 3] (type 3), else None


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


def _row_bytes(width: int, ctype: int, depth: int) -> int:
    return (width * CHANNELS[ctype] * depth + 7) // 8


def _filter_bpp(ctype: int, depth: int) -> int:
    """Bytes of the filters' pixel: ``ceil(bits per pixel / 8)``."""
    return max(1, CHANNELS[ctype] * depth // 8)


def _passes(H: int, W: int, interlace: int):
    """(first row, first column, row step, column step, rows, columns) of
    each pass: the whole image, or Adam7's seven."""
    if not interlace:
        return [(0, 0, 1, 1, H, W)]
    return [(y0, x0, dy, dx, max(0, -(-(H - y0) // dy)), max(0, -(-(W - x0) // dx)))
            for y0, x0, dy, dx in ADAM7]


def parse(data: bytes) -> Parsed:
    """The header, palette and filtered rows of a PNG (:class:`Parsed`)."""
    header, idat, plte = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    W, H, depth, ctype, compression, filt, interlace = header
    if ctype not in CHANNELS:
        raise PNGError(f"unknown colour type {ctype}")
    if depth not in DEPTHS[ctype]:
        raise PNGError(f"bit depth {depth} is not allowed for colour type {ctype}")
    if interlace not in (0, 1):
        raise PNGError(f"unknown interlace method {interlace}")
    if compression != 0 or filt != 0:
        raise PNGError(f"unknown compression {compression} or filter method {filt}")
    palette = None
    if ctype == 3:
        if plte is None or len(plte) % 3 or len(plte) > 768:
            raise PNGError("a palette image needs a PLTE chunk of at most 256 RGB entries")
        palette = np.zeros((256, 3), np.uint8)          # an index past the end reads black
        palette[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    shapes = [(h, 1 + _row_bytes(w, ctype, depth)) if h and w else None
              for *_, h, w in _passes(H, W, interlace)]
    expected = sum(h * stride for h, stride in filter(None, shapes))
    if raw.size != expected:
        raise PNGError(f"image data holds {raw.size} bytes, expected {expected}")
    passes, pos = [], 0
    for shape in shapes:
        passes.append(None if shape is None else raw[pos:pos + shape[0] * shape[1]].reshape(shape))
        pos += 0 if shape is None else shape[0] * shape[1]
    for p in passes:
        if p is not None and p[:, 0].max(initial=0) > 4:
            raise PNGError(f"unknown row filter {int(p[:, 0].max())}")
    rows = tuple(passes) if interlace else passes[0]
    return Parsed(H, W, ctype, rows, depth, interlace, palette)


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


def _samples(data: np.ndarray, width: int, ctype: int, depth: int) -> np.ndarray:
    """Unfiltered bytes uint8 [..., h, row bytes] -> samples [..., h, width,
    channels]: uint8 (up to 8 bits, sub-byte samples unpacked from the high
    bits down) or uint16."""
    C = CHANNELS[ctype]
    lead = data.shape[:-1]
    if depth == 16:
        return data.view(">u2").astype(np.uint16).reshape(*lead, width, C)
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(per - 1, -1, -1, dtype=np.uint8) * depth
        vals = (data[..., None] >> shifts) & ((1 << depth) - 1)
        data = vals.reshape(*lead, -1)[..., :width * C]
    return data.reshape(*lead, width, C)


def _as_image(pixels: np.ndarray, ctype: int, depth: int = 8,
              palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Samples [..., H, W, channels] -> the array imageio returns (module
    docstring)."""
    if ctype == 3:
        return palette[pixels[..., 0]]
    if ctype == 0:
        grey = pixels[..., 0]
        if depth == 1:
            return grey.astype(bool)
        return (grey * (255 // ((1 << depth) - 1))).astype(np.uint8) if depth < 8 else grey
    if depth == 16:
        high = (pixels >> 8).astype(np.uint8)
        if ctype == 4:                  # pillow widens 16-bit grey + alpha to RGBA
            return high[..., [0, 0, 0, 1]]
        return high
    return pixels


def _decode_batch(parsed: Sequence[Parsed]) -> List[np.ndarray]:
    """Decode PNGs of one size, colour type, depth and interlacing together."""
    H, W, ctype, _, depth, interlace, _ = parsed[0]
    bpp = _filter_bpp(ctype, depth)
    samples = None
    for k, (y0, x0, dy, dx, h, w) in enumerate(_passes(H, W, interlace)):
        if h == 0 or w == 0:
            continue
        rows = np.stack([p.rows[k] if interlace else p.rows for p in parsed])
        unfiltered = _unfilter(rows, bpp).reshape(len(parsed), h, -1)
        part = _samples(unfiltered, w, ctype, depth)
        if not interlace:
            samples = part
            break
        if samples is None:
            samples = np.empty((len(parsed), H, W, CHANNELS[ctype]), part.dtype)
        samples[:, y0::dy, x0::dx] = part
    return [_as_image(img, ctype, depth, p.palette) for img, p in zip(samples, parsed)]


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> the array ``imageio.v2.imread`` gives (module docstring)."""
    return _decode_batch([parse(data)])[0]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode several files, those of one size, colour type, depth and
    interlacing together in batches of at most ``BATCH_BYTES`` of working
    set; the images in the order of ``paths``."""
    parsed = []
    for path in paths:
        with open(path, "rb") as f:
            parsed.append(parse(f.read()))
    out: List[np.ndarray] = [None] * len(parsed)
    groups = {}
    for i, p in enumerate(parsed):
        groups.setdefault((p.H, p.W, p.ctype, p.depth, p.interlace), []).append(i)
    for (H, W, ctype, depth, _), idx in groups.items():
        bpp = _filter_bpp(ctype, depth)
        wide = _row_bytes(W, ctype, depth) // bpp
        per_image = 2 * (H + 1) * (H + wide + 1) * bpp * 2
        step = max(1, BATCH_BYTES // per_image)
        for s in range(0, len(idx), step):
            part = idx[s:s + step]
            for i, img in zip(part, _decode_batch([parsed[i] for i in part])):
                out[i] = img
    return out


def pixel_max(dtype) -> int:
    """The largest value of a decoded image's dtype: 1 (bool), 255 (uint8)
    or 65535 (uint16)."""
    dtype = np.dtype(dtype)
    return 1 if dtype == np.bool_ else int(np.iinfo(dtype).max)


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
