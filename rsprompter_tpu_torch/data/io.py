"""Image files -> uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``
(HWC BGR) and ``cv2.imread(path, IMREAD_GRAYSCALE)`` (HW) read them.

The JAX package reads images with OpenCV (``data/coco.py:117``, and the
WHU converter's masks in grey); the card's machine has neither OpenCV nor
PIL. So the port decodes by the file's magic, itself:

- PNG with ``zlib`` and numpy: every colour type and bit depth (grey at 1,
  2, 4, 8 and 16 bits, palette with or without ``tRNS``, grey + alpha, RGB
  and RGBA at 8 and 16), non-interlaced or Adam7, all five row filters.
  libpng's transforms as OpenCV sets them: 16-bit samples keep their high
  byte, sub-byte grey is scaled to 8 bits, alpha and ``tRNS`` are dropped,
  grey is repeated into three channels, and a colour file read in grey goes
  through ``png_set_rgb_to_gray`` (``_png_rgb_to_gray``);
- TIFF (``II*\\0``, ``MM\\0*``) with ``data/tiff.py``;
- JPEG (SOI marker) with the port's baseline decoder (``data/jpeg.py``);
- ``.npy`` files as they are.

A file of these formats that the port refuses raises ``ValueError``; it is
never handed to OpenCV. The error is ``NotDecoded`` (a ``ValueError``) where
the file is valid and OpenCV would decode it, so that a caller that skips
what ``cv2.imread`` cannot read, as ``whu2coco`` does, still stops on it.
Any other format goes to ``cv2.imread`` where OpenCV imports, and raises
``NotDecoded`` otherwise. ``decode_image`` does the same
for bytes (the server's request bodies) without the OpenCV branch.
``encode_png`` and ``imwrite`` write the port's drawn images: ``imwrite``
picks the format by the file's extension as ``cv2.imwrite`` does (``.jpg``
/ ``.jpeg``: the port's JPEG encoder at OpenCV's default quality 95;
``.png``: ``encode_png``).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

from rsprompter_tpu_torch.data.jpeg import JPEG_SOI, NotDecoded, decode_jpeg, encode_jpeg
from rsprompter_tpu_torch.data.tiff import TIFF_MAGIC, decode_tiff

IMREAD_GRAYSCALE, IMREAD_COLOR = 0, 1  # cv2's values

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
# PNG colour type -> channels and bit depths
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# png_set_rgb_to_gray_fixed's weights of 0.299 and 0.587 (truncated to
# 15 bits), blue the rest
PNG_GRAY_R, PNG_GRAY_G = 9797, 19234
PNG_GRAY_B = (1 << 15) - PNG_GRAY_R - PNG_GRAY_G
PNG_GAMMA_THRESHOLD = 5000  # PNG_GAMMA_THRESHOLD_FIXED: a gamma this near 1 is none
PNG_SRGB_GAMMA = 45455
PNG_MAX_PIXELS = 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_PIXELS
PNG_LEVEL = 1  # zlib level of encode_png: OpenCV's default PNG compression


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 BGR, or (H, W) uint8 with
    ``flags=IMREAD_GRAYSCALE`` (a ``.npy`` file: its array)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"imread flags {flags!r}: IMREAD_COLOR (1) or IMREAD_GRAYSCALE (0)")
    with open(path, "rb") as f:
        head = f.read(8)
        if _is_decoded(head):
            return decode_image(head + f.read(), flags, str(path))
    try:
        import cv2
    except ImportError:
        raise NotDecoded(
            f"{path}: no decoder for this format on this machine (the port decodes PNG, "
            "TIFF, JPEG and .npy itself; other formats need OpenCV)") from None
    img = cv2.imread(path, flags)
    if img is None:
        raise ValueError(f"{path}: OpenCV cannot decode this file")
    return img


def _is_decoded(head: bytes) -> bool:
    return (head.startswith(PNG_SIGNATURE) or head[:4] in TIFF_MAGIC
            or head.startswith(JPEG_SOI) or head.startswith(NPY_MAGIC))


def decode_image(data: bytes, flags: int = IMREAD_COLOR, name: str = "image data") -> np.ndarray:
    """PNG, TIFF, JPEG or ``.npy`` bytes -> (H, W, 3) uint8 BGR, or (H, W)
    uint8 with ``flags=IMREAD_GRAYSCALE`` (``.npy``: its array); anything
    else raises ``ValueError``."""
    gray = flags == IMREAD_GRAYSCALE
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, gray)
    if data[:4] in TIFF_MAGIC:
        return decode_tiff(data, name, gray)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, name, gray)
    if data.startswith(NPY_MAGIC):
        return np.load(io.BytesIO(data), allow_pickle=False)
    raise ValueError(f"{name}: not a PNG, JPEG, TIFF or .npy image")


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 BGR -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter byte 0, then RGB
    rows[:, 1:] = img[:, :, ::-1].reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL)) + chunk(b"IEND", b""))


JPEG_EXTENSIONS = (".jpg", ".jpeg")


def drawn_name(path: str) -> str:
    """The file name a drawing of the image at ``path`` is written under:
    its basename, as JAX's ``cv2.imwrite`` keeps it, where the port writes
    that format (JPEG, PNG), else the basename with ``.png``."""
    name = os.path.basename(os.fspath(path))
    stem, ext = os.path.splitext(name)
    return name if ext.lower() in JPEG_EXTENSIONS + (".png",) else stem + ".png"


def imwrite(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write (H, W, 3) uint8 BGR to ``path``: JPEG at ``quality`` for a
    ``.jpg`` / ``.jpeg`` name, PNG for ``.png``; any other name raises
    ``ValueError``."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext in JPEG_EXTENSIONS:
        data = encode_jpeg(img, quality)
    elif ext == ".png":
        data = encode_png(img)
    else:
        raise ValueError(f"{path}: the port writes .jpg, .jpeg and .png, not {ext!r}")
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR, or (H, W) uint8 with ``gray``:
    ``cv2.imread``'s bytes under ``IMREAD_COLOR`` / ``IMREAD_GRAYSCALE``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, gamma, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR of {len(body)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"gAMA" and len(body) == 4 and gamma is None:
            gamma = struct.unpack(">I", body)[0]
        elif kind == b"sRGB":
            gamma = PNG_SRGB_GAMMA
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth not in PNG_DEPTHS.get(colour, ()) or interlace > 1:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: not a PNG form that is decoded")
    if colour == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if w * h > PNG_MAX_PIXELS or w == 0 or h == 0:
        raise ValueError(f"PNG of {w} x {h} pixels")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:  # a cut or corrupt file
        raise ValueError(f"PNG data do not inflate: {err}") from None
    s = _png_samples(np.frombuffer(raw, np.uint8), w, h, depth, PNG_CHANNELS[colour],
                     interlace)
    if colour == 3:
        if int(s.max(initial=0)) >= len(palette):
            raise ValueError(f"PNG palette index {int(s.max())} past its "
                             f"{len(palette)} entries")
        s = palette[s[:, :, 0]]
    elif colour in (0, 4) and depth < 8:  # png_set_expand_gray_1_2_4_to_8
        s = s * (255 // ((1 << depth) - 1))
    if colour & 2 == 0:  # grey (+ alpha): its plane
        g = s[:, :, 0]
        g = (g >> 8).astype(np.uint8) if depth == 16 else g.astype(np.uint8)
        return g if gray else np.repeat(g[:, :, None], 3, axis=2)
    rgb = s[:, :, :3]
    if gray:
        return _png_rgb_to_gray(rgb, depth, gamma)
    if depth == 16:  # png_set_strip_16: the high byte
        rgb = rgb >> 8
    return np.ascontiguousarray(rgb[:, :, ::-1].astype(np.uint8))


def _png_rgb_to_gray(rgb: np.ndarray, depth: int, gamma) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, as OpenCV
    sets it: truncated 15-bit weights at 8 bits, rounded at 16 bits then
    the high byte; with a significant file gamma (``gAMA`` more than 0.05
    from 1, or ``sRGB``) at 8 bits through libpng's gamma tables."""
    r, g, b = (rgb[:, :, i].astype(np.int64) for i in range(3))
    if gamma is not None and abs(gamma - 100000) > PNG_GAMMA_THRESHOLD:
        if depth == 16:
            raise NotDecoded("16-bit colour PNG with a file gamma: its grey read "
                             "(libpng's 16-bit gamma tables) is not decoded")
        i = np.arange(256) / 255.0
        to_linear = np.floor(255 * i ** (100000 / gamma) + 0.5).astype(np.int64)
        from_linear = np.floor(255 * i ** (gamma / 100000) + 0.5).astype(np.uint8)
        lin = (PNG_GRAY_R * to_linear[r] + PNG_GRAY_G * to_linear[g]
               + PNG_GRAY_B * to_linear[b] + (1 << 14)) >> 15
        same = (r == g) & (g == b)
        return np.where(same, r, from_linear[lin]).astype(np.uint8)
    y = PNG_GRAY_R * r + PNG_GRAY_G * g + PNG_GRAY_B * b
    if depth == 16:
        return (((y + (1 << 14)) >> 15) >> 8).astype(np.uint8)
    return (y >> 15).astype(np.uint8)


def _png_samples(raw: np.ndarray, w: int, h: int, depth: int, ch: int,
                 interlace: int) -> np.ndarray:
    """Inflated IDAT -> (H, W, ch) samples (uint8, or uint16 at depth 16);
    Adam7's seven passes each unfiltered as an image of its own."""
    bits = depth * ch
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError(f"PNG data of {raw.size} bytes end inside the image "
                             f"({pos + n} needed)")
        rows = raw[pos:pos + n].reshape(ph, stride + 1)
        pos += n
        pix = unfilter(rows[:, 0], rows[:, 1:], max(1, bits // 8))
        out[y0::dy, x0::dx] = _png_unpack(pix, pw, ch, depth)
    return out


def _png_unpack(pix: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(rows, stride) unfiltered bytes -> (rows, w, ch) samples."""
    rows = pix.shape[0]
    if depth == 16:
        return pix.view(">u2").astype(np.uint16).reshape(rows, w, ch)
    if depth < 8:  # MSB first, each row padded to a byte
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pix = ((pix[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(rows, -1)
    return pix[:, :w * ch].reshape(rows, w, ch)


def _unfilter_diagonals(kinds: np.ndarray, filtered: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters, one anti-diagonal ``y + x = d`` of pixels at a time:
    a pixel's predictors (left, up, up-left) all lie on the two diagonals
    before its own, so each diagonal is a handful of numpy operations.
    Pixel (y, x) is kept at ``[d + 2, y + 1]`` of a skewed array whose
    first two rows, first column and slots outside the image stay 0, PNG's
    border."""
    h, stride = filtered.shape
    w = stride // bpp
    y, x = np.divmod(np.arange(h * w), w)
    out = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    f = np.zeros_like(out)
    f[y + x + 2, y + 1] = filtered.reshape(h * w, bpp)
    k = np.zeros(h + 1, np.int64)
    k[1:] = kinds
    sub, up, avg, paeth = ((k == i)[:, None] for i in (1, 2, 3, 4))
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1) + 1, min(h - 1, d) + 2
        a = out[d + 1, lo:hi]  # left: diagonal d - 1
        b = out[d + 1, lo - 1:hi - 1]  # up: diagonal d - 1
        c = out[d, lo - 1:hi - 1]  # up-left: diagonal d - 2
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pp = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        s = slice(lo, hi)
        pred = (np.where(sub[s], a, 0) + np.where(up[s], b, 0)
                + np.where(avg[s], (a + b) >> 1, 0) + np.where(paeth[s], pp, 0))
        out[d + 2, lo:hi] = (f[d + 2, lo:hi] + pred) & 0xFF
    return out[y + x + 2, y + 1].astype(np.uint8).reshape(h, stride)


def unfilter(kinds: np.ndarray, filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``kinds`` (H,) filter bytes, ``filtered``
    (H, stride) -> (H, stride) uint8. An image of None, Sub and Up rows only
    is undone a whole row at a time; one with Average or Paeth rows, whose
    bytes each depend on the byte before, a diagonal at a time."""
    h, stride = filtered.shape
    if h and int(kinds.max()) > 4:
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"PNG row {y}: unknown filter type {int(kinds[y])}")
    if np.isin(kinds, (3, 4)).any():
        return _unfilter_diagonals(kinds, filtered, bpp)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, kind = filtered[y], int(kinds[y])
        if kind == 0:
            row = f
        elif kind == 1:  # Sub: a running sum, mod 256, per channel
            row = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            row = f + prev
        out[y] = row
        prev = out[y]
    return out
