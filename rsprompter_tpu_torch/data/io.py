"""Image files -> HWC BGR uint8 arrays, as ``cv2.imread(path, IMREAD_COLOR)``.

The JAX package reads images with OpenCV (``data/coco.py:117``); the card's
machine has neither OpenCV nor PIL. So the port decodes PNG itself, with
``zlib`` and numpy: 8-bit grey, grey + alpha, RGB and RGBA, non-interlaced,
all five row filters. Alpha is dropped and grey is repeated into three
channels, as ``IMREAD_COLOR`` does. A file that starts with JPEG's SOI
marker goes to the port's baseline decoder (``data/jpeg.py``), never to
OpenCV, which raises for a JPEG it refuses. ``.npy`` files are read as they
are. Any other format goes to ``cv2.imread`` where OpenCV imports, and
raises ``ValueError`` otherwise. ``decode_image`` does the same for bytes
(the server's request bodies), and ``encode_png`` writes the port's drawn
images.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from rsprompter_tpu_torch.data.jpeg import JPEG_SOI, decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
# PNG colour type -> channels (8-bit samples); 3 (palette) is not decoded
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
PNG_LEVEL = 1  # zlib level of encode_png: OpenCV's default PNG compression


def imread(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 BGR (a ``.npy`` file: its array)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head == PNG_SIGNATURE:
            return decode_png(head + f.read())
        if head.startswith(JPEG_SOI):
            return decode_jpeg(head + f.read(), str(path))
    if head.startswith(NPY_MAGIC):
        return np.load(path)
    try:
        import cv2
    except ImportError:
        raise ValueError(
            f"{path}: no decoder for this format on this machine (the port decodes PNG, "
            "JPEG and .npy itself; other formats need OpenCV)") from None
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"{path}: OpenCV cannot decode this file")
    return img


def decode_image(data: bytes) -> np.ndarray:
    """PNG, JPEG or ``.npy`` bytes -> (H, W, 3) uint8 BGR (``.npy``: its
    array); anything else raises ``ValueError``."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data)
    if data.startswith(NPY_MAGIC):
        return np.load(io.BytesIO(data), allow_pickle=False)
    raise ValueError("not a PNG, JPEG or .npy image")


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


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in PNG_CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}: only 8-bit grey, grey + alpha, RGB and RGBA, "
                         "non-interlaced, are decoded")
    ch = PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * ch
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {h} rows of {stride}")
    rows = raw.reshape(h, stride + 1)
    pix = unfilter(rows[:, 0], rows[:, 1:], ch)
    img = pix.reshape(h, w, ch)
    if ch <= 2:  # grey (+ alpha): the grey channel three times
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])  # RGB(A) -> BGR


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
