"""TIFF files <-> arrays, as ``cv2.imread`` reads them (libtiff under OpenCV).

WHU building's aerial tiles and masks are TIFF, and the card's machine has
neither OpenCV nor PIL. ``decode_tiff`` reads the first image of a file as
``cv2.imread(path, IMREAD_COLOR)`` (BGR) or ``IMREAD_GRAYSCALE`` does: for
8-bit output OpenCV has libtiff convert every file to 8-bit RGBA
(``TIFFReadRGBA*``, tif_getimage.c) and then drops alpha or takes grey
with its own fixed-point weights, and so does this module:

- byte orders ``II`` and ``MM``; strips (``RowsPerStrip`` missing: one
  strip) and tiles (the parts of edge tiles past the image are dropped);
- compression 1 (none), 32773 (PackBits) and 5 (LZW), with predictor 1 or 2
  (horizontal differences per sample, 8- and 16-bit);
  ``rsprompter_tpu_torch/native/tiff.cpp`` decompresses, built with ``g++``
  at first use into ``build/native/`` and bound with ctypes;
- photometric 0 (min-is-white), 1 (min-is-black), 2 (RGB) and 3 (palette);
  1-, 8- and 16-bit samples (16-bit to 8 as libtiff brings them: the high
  byte for grey, ``(v + 128) / 257`` for RGB; a palette's 16-bit entries
  ``>> 8`` unless all are below 256); 1, 3 or 4 samples a pixel, planar
  configuration 1. A fourth sample is alpha:
  unassociated alpha (``ExtraSamples`` 2) is multiplied in as libtiff does,
  associated or unspecified alpha is dropped.

Any other value of a tag that decides the pixels (compression, photometric,
bits, samples, planar configuration, predictor, sample format, fill order,
orientation, extra samples), BigTIFF, a strip or tile outside the file and
data that end early raise ``ValueError`` naming the tag and its value or
the fault; nothing falls back to another library. Where libtiff under
OpenCV would decode the file (another tag value, BigTIFF) the error is
``data.jpeg.NotDecoded``.

``encode_tiff`` writes the same forms (for seeded test sets and fixtures).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rsprompter_tpu_torch.data.jpeg import NotDecoded
from rsprompter_tpu_torch.utils import native

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "tiff.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
TIFF_MAGIC = (b"II*\x00", b"MM\x00*")
_ERR_LEN = 256
_SIGNATURES = {
    name: (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_char_p, ctypes.c_int])
    for name in ("tiff_lzw_decode", "tiff_packbits_decode")
}
_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()

# tags
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, ORIENTATION, SAMPLES = 266, 273, 274, 277
ROWS_PER_STRIP, STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP = 278, 279, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339
NONE, LZW, PACKBITS = 1, 5, 32773
MIN_IS_WHITE, MIN_IS_BLACK, RGB, PALETTE = 0, 1, 2, 3
UNASSOCIATED_ALPHA = 2
# IFD entry type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4)}
# OpenCV's icvCvt_BGRA2Gray_8u_C4C1R: round(0.299 / 0.587 * 2^14), blue the rest
GRAY_R, GRAY_G = 4899, 9617
GRAY_B = (1 << 14) - GRAY_R - GRAY_G


def load_library() -> ctypes.CDLL:
    with _lock:
        if SOURCE not in _libs:
            _libs[SOURCE] = native.load_library(SOURCE, BUILD_DIR, _SIGNATURES)
        return _libs[SOURCE]


def _decompress(kind: int, chunk: bytes, size: int, what: str) -> np.ndarray:
    if kind == NONE:
        out = np.frombuffer(chunk, np.uint8)[:size]
        n = out.size
    else:
        lib = load_library()
        out = np.empty(size, np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        fn = lib.tiff_lzw_decode if kind == LZW else lib.tiff_packbits_decode
        n = fn(chunk, len(chunk), out.ctypes.data, size, err, _ERR_LEN)
        if n < 0:
            raise ValueError(f"{what}: {err.value.decode()}")
    if n < size:
        raise ValueError(f"{what}: data end after {n} of {size} bytes")
    return out


def _ifd(data: bytes, name: str) -> Tuple[str, Dict[int, Tuple[int, ...]]]:
    """The byte order and the first IFD's tags -> their values (integers)."""
    if len(data) < 8 or data[:4] not in TIFF_MAGIC:
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise NotDecoded(f"{name}: BigTIFF is not decoded")
        raise ValueError(f"{name}: not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    (pos,) = struct.unpack(bo + "I", data[4:8])
    if pos + 2 > len(data):
        raise ValueError(f"{name}: IFD offset {pos} is past the end of the file")
    (count,) = struct.unpack(bo + "H", data[pos:pos + 2])
    if pos + 2 + 12 * count > len(data):
        raise ValueError(f"{name}: the IFD's {count} entries run past the end of the file")
    tags = {}
    for i in range(count):
        tag, kind, n, raw = struct.unpack(bo + "HHI4s", data[pos + 2 + 12 * i:pos + 14 + 12 * i])
        if kind not in _TYPES:
            continue  # rationals, floats, ASCII-like: no pixel-deciding tag has them
        code, size = _TYPES[kind]
        if n * size <= 4:
            body = raw[:n * size]
        else:
            (off,) = struct.unpack(bo + "I", raw)
            if off + n * size > len(data):
                raise ValueError(f"{name}: tag {tag}'s {n} values run past the end of the file")
            body = data[off:off + n * size]
        tags[tag] = struct.unpack(f"{bo}{n}{code}", body)
    return bo, tags


def _one(tags, tag: int, default: Optional[int], name: str, what: str) -> int:
    if tag not in tags:
        if default is None:
            raise ValueError(f"{name}: no {what} (tag {tag})")
        return default
    return int(tags[tag][0])


def _refuse(name: str, what: str, tag: int, value) -> None:
    raise NotDecoded(f"{name}: {what} (tag {tag}) = {value} is not decoded")


def _unpack(raw: np.ndarray, rows: int, row_bytes: int, width: int, spp: int, bits: int,
            bo: str) -> np.ndarray:
    """(rows * row_bytes) bytes -> (rows, width, spp) samples (uint8 / uint16)."""
    raw = raw.reshape(rows, row_bytes)
    if bits == 8:
        return raw[:, :width * spp].reshape(rows, width, spp)
    if bits == 16:
        return raw[:, :2 * width * spp].view(bo + "u2").astype(np.uint16).reshape(rows, width, spp)
    return np.unpackbits(raw, axis=1)[:, :width * spp].reshape(rows, width, spp)  # 1-bit


def _undo_predictor(s: np.ndarray) -> np.ndarray:
    """Predictor 2: a running sum along each row, per sample, modulo 2^bits."""
    return np.cumsum(s, axis=1, dtype=s.dtype)


def _samples(data: bytes, bo: str, tags, name: str):
    """The image's samples, (H, W, spp) uint8 / uint16, and its tags decoded."""
    w = _one(tags, WIDTH, None, name, "ImageWidth")
    h = _one(tags, HEIGHT, None, name, "ImageLength")
    spp = _one(tags, SAMPLES, 1, name, "SamplesPerPixel")
    photometric = _one(tags, PHOTOMETRIC, None, name, "PhotometricInterpretation")
    bits_all = tags.get(BITS, (1,))
    bits = int(bits_all[0])
    compression = _one(tags, COMPRESSION, NONE, name, "Compression")
    predictor = _one(tags, PREDICTOR, 1, name, "Predictor")
    if compression not in (NONE, LZW, PACKBITS):
        _refuse(name, "Compression", COMPRESSION, compression)
    if photometric not in (MIN_IS_WHITE, MIN_IS_BLACK, RGB, PALETTE):
        _refuse(name, "PhotometricInterpretation", PHOTOMETRIC, photometric)
    if len(set(bits_all)) != 1 or bits not in (1, 8, 16):
        _refuse(name, "BitsPerSample", BITS, bits_all)
    if spp not in ((3, 4) if photometric == RGB else (1,)):
        _refuse(name, "SamplesPerPixel", SAMPLES, spp)
    if (photometric == RGB and bits == 1) or (photometric == PALETTE and bits == 16):
        _refuse(name, "BitsPerSample", BITS, bits_all)
    for tag, what, ok in ((PLANAR, "PlanarConfiguration", (1,)),
                          (SAMPLE_FORMAT, "SampleFormat", (1,)),
                          (FILL_ORDER, "FillOrder", (1,)),
                          (ORIENTATION, "Orientation", (1,)),
                          (EXTRA_SAMPLES, "ExtraSamples", (0, 1, 2))):
        for v in tags.get(tag, ()):
            if v not in ok:
                _refuse(name, what, tag, tags[tag] if len(tags[tag]) > 1 else v)
    if predictor not in (1, 2) or (predictor == 2 and bits == 1):
        _refuse(name, "Predictor", PREDICTOR, predictor)
    if w <= 0 or h <= 0 or w * h > 1 << 30:
        raise ValueError(f"{name}: image of {w} x {h} pixels")
    if TILE_WIDTH in tags:
        cw = _one(tags, TILE_WIDTH, None, name, "TileWidth")
        ch = _one(tags, TILE_LENGTH, None, name, "TileLength")
        offsets, counts = tags.get(TILE_OFFSETS), tags.get(TILE_BYTES)
        across, down = -(-w // max(cw, 1)), -(-h // max(ch, 1))
        what = "tile"
    else:
        cw, ch = w, min(_one(tags, ROWS_PER_STRIP, h, name, "RowsPerStrip"), h)
        offsets, counts = tags.get(STRIP_OFFSETS), tags.get(STRIP_BYTES)
        across, down = 1, -(-h // max(ch, 1))
        what = "strip"
    if cw <= 0 or ch <= 0 or across * cw * down * ch > 1 << 30:
        raise ValueError(f"{name}: {across * down} {what}s of {cw} x {ch} pixels")
    if offsets is None or counts is None or len(offsets) < across * down \
            or len(counts) < len(offsets):
        raise ValueError(f"{name}: {across * down} {what}s but "
                         f"{0 if offsets is None else len(offsets)} offsets")
    row_bytes = -(-cw * spp * bits // 8)
    out = np.empty((down * ch, across * cw, spp), np.uint16 if bits == 16 else np.uint8)
    for i in range(across * down):
        ty, tx = divmod(i, across)
        rows = ch if what == "tile" else min(ch, h - ty * ch)
        off, n = int(offsets[i]), int(counts[i])
        if off + n > len(data):
            raise ValueError(f"{name}: {what} {i} at {off} + {n} runs past the end "
                             f"of the file ({len(data)} bytes)")
        raw = _decompress(compression, data[off:off + n], rows * row_bytes, f"{name}: {what} {i}")
        s = _unpack(raw, rows, row_bytes, cw, spp, bits, bo)
        if predictor == 2:
            s = _undo_predictor(s)
        out[ty * ch:ty * ch + rows, tx * cw:(tx + 1) * cw] = s
    return out[:h, :w], photometric, bits, spp, tags


def _to8(s: np.ndarray, bits: int, grey: bool) -> np.ndarray:
    if bits == 16 and grey:  # tif_getimage.c put16bitbwtile: the high byte
        return (s >> 8).astype(np.uint8)
    if bits == 16:  # BuildMapBitdepth16To8
        return ((s.astype(np.uint32) + 128) // 257).astype(np.uint8)
    if bits == 1:
        return s.astype(np.uint8) * 255
    return s


def _rgb(s: np.ndarray, photometric: int, bits: int, spp: int, tags, name: str) -> np.ndarray:
    """Samples -> (H, W, 3) uint8 RGB, as libtiff's RGBA image (alpha dropped
    or multiplied in); a grey image -> its (H, W) plane."""
    if photometric == PALETTE:
        cmap = tags.get(COLORMAP)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise ValueError(f"{name}: palette image without a ColorMap (tag {COLORMAP}) "
                             f"of {3 * n} entries")
        cmap = np.asarray(cmap[:3 * n], np.uint16).reshape(3, n)
        if (cmap >= 256).any():  # tif_getimage.c checkcmap / cvtcmap
            cmap = cmap >> 8
        return cmap.astype(np.uint8).T[s[:, :, 0].astype(np.intp)]
    v = _to8(s, bits, photometric != RGB)
    if photometric in (MIN_IS_WHITE, MIN_IS_BLACK):  # one plane: r = g = b
        return v[:, :, 0] if photometric == MIN_IS_BLACK else 255 - v[:, :, 0]
    rgb = v[:, :, :3]
    if spp == 4 and tags.get(EXTRA_SAMPLES, (0,))[0] == UNASSOCIATED_ALPHA:
        a = v[:, :, 3:4].astype(np.uint32)  # BuildMapUaToAa: (v a + 127) / 255
        rgb = ((rgb.astype(np.uint32) * a + 127) // 255).astype(np.uint8)
    return rgb


def decode_tiff(data: bytes, name: str = "TIFF data", gray: bool = False) -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 BGR, or (H, W) uint8 with ``gray``:
    ``cv2.imread``'s bytes under ``IMREAD_COLOR`` / ``IMREAD_GRAYSCALE``."""
    bo, tags = _ifd(data, name)
    s, photometric, bits, spp, tags = _samples(data, bo, tags, name)
    rgb = _rgb(s, photometric, bits, spp, tags, name)
    if rgb.ndim == 2:  # grey: OpenCV's weights sum to 1, so the plane is its grey
        return np.ascontiguousarray(rgb) if gray else np.repeat(rgb[:, :, None], 3, axis=2)
    if gray:
        r, g, b = (rgb[:, :, i].astype(np.uint32) for i in range(3))
        return ((r * GRAY_R + g * GRAY_G + b * GRAY_B + (1 << 13)) >> 14).astype(np.uint8)
    return np.ascontiguousarray(rgb[:, :, ::-1])


# --- writing ---------------------------------------------------------------


def packbits(row: bytes) -> bytes:
    """PackBits (tif_packbits.c's format): runs of 3 or more equal bytes as
    repeats, the bytes between them as literals, 128 bytes a packet at most."""
    a = np.frombuffer(row, np.uint8)
    if a.size == 0:
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    lengths = np.diff(np.r_[starts, a.size])
    long = lengths >= 3
    out = bytearray()

    def literal(lo: int, hi: int) -> None:
        for i in range(lo, hi, 128):
            part = row[i:min(i + 128, hi)]
            out.append(len(part) - 1)
            out.extend(part)

    pos = 0
    for s, n in zip(starts[long].tolist(), lengths[long].tolist()):
        literal(pos, s)
        pos = s + n
        while n >= 3:
            k = min(n, 128)
            out.append(257 - k)
            out.append(row[s])
            n -= k
        literal(pos - n, pos)  # a tail of 1 or 2
    literal(pos, len(row))
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW (tif_lzw.c's encoder): Clear first, codes MSB-first widening
    one entry early, Clear again when the table is full, EOI last."""
    out, acc, nacc = bytearray(), 0, 0
    nbits, free, maxcode = 9, 258, 511
    table: Dict[bytes, int] = {}

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    w = b""
    for byte in data:
        wc = w + bytes((byte,))
        if not w or wc in table:
            w = wc
            continue
        put(table[w] if len(w) > 1 else w[0])
        table[wc] = free
        free += 1
        w = bytes((byte,))
        if free == 4094:
            put(256)
            table.clear()
            nbits, free, maxcode = 9, 258, 511
        elif free > maxcode:
            nbits += 1
            maxcode = (1 << nbits) - 1
    if w:
        put(table[w] if len(w) > 1 else w[0])
        free += 1  # the decoder adds one more entry, which may widen the EOI
        if free > maxcode and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _pack(s: np.ndarray, bits: int, bo: str) -> np.ndarray:
    """(rows, width, spp) samples -> (rows, row_bytes) uint8."""
    rows = s.shape[0]
    if bits == 16:
        return s.astype(bo + "u2").reshape(rows, -1).view(np.uint8)
    if bits == 1:
        return np.packbits(s.reshape(rows, -1).astype(np.uint8) & 1, axis=1)
    return s.astype(np.uint8).reshape(rows, -1)


def encode_tiff(samples: np.ndarray, photometric: int, bits: int = 8, compression: int = NONE,
                predictor: int = 1, byteorder: str = "<", tile: Optional[Tuple[int, int]] = None,
                rows_per_strip: Optional[int] = None, colormap: Optional[np.ndarray] = None,
                extra_samples: Optional[int] = None, extra_tags: Sequence = ()) -> bytes:
    """(H, W) or (H, W, spp) samples -> TIFF bytes: one image, planar
    configuration 1, in strips of ``rows_per_strip`` rows (None: one strip,
    and no ``RowsPerStrip`` tag) or tiles of ``tile`` = (width, length),
    the parts of edge tiles past the image filled with the image wrapped
    around. ``colormap`` is (3, 2^bits) 16-bit entries for a palette image;
    ``extra_tags`` are (tag, type, values) entries written as given."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[:, :, None]
    h, w, spp = s.shape
    bo = "<" if byteorder in ("<", "II") else ">"
    store = s.astype(np.uint16 if bits == 16 else np.uint8)
    if tile is not None:
        cw, ch = tile
        store = np.pad(store, ((0, -h % ch), (0, -w % cw), (0, 0)), mode="wrap")
        blocks = [store[y:y + ch, x:x + cw] for y in range(0, store.shape[0], ch)
                  for x in range(0, store.shape[1], cw)]
    else:
        ch = rows_per_strip or h
        blocks = [store[y:y + ch] for y in range(0, h, ch)]
    chunks = []
    for b in blocks:
        if predictor == 2:
            b = b.copy()
            b[:, 1:] = b[:, 1:] - b[:, :-1]  # wraps modulo 2^bits in the unsigned dtype
        raw = _pack(b, bits, bo).tobytes()
        if compression == PACKBITS:
            row = len(raw) // b.shape[0]
            raw = b"".join(packbits(raw[i:i + row]) for i in range(0, len(raw), row))
        elif compression == LZW:
            raw = lzw(raw)
        chunks.append(raw)
    body = bytearray(b"II*\x00" if bo == "<" else b"MM\x00*") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body.append(0)
    entries = [(WIDTH, 4, [w]), (HEIGHT, 4, [h]), (BITS, 3, [bits] * spp),
               (COMPRESSION, 3, [compression]), (PHOTOMETRIC, 3, [photometric]),
               (SAMPLES, 3, [spp]), (PLANAR, 3, [1])]
    if tile is not None:
        entries += [(TILE_WIDTH, 4, [tile[0]]), (TILE_LENGTH, 4, [tile[1]]),
                    (TILE_OFFSETS, 4, offsets), (TILE_BYTES, 4, [len(c) for c in chunks])]
    else:
        entries += [(STRIP_OFFSETS, 4, offsets), (STRIP_BYTES, 4, [len(c) for c in chunks])]
        if rows_per_strip is not None:
            entries.append((ROWS_PER_STRIP, 4, [rows_per_strip]))
    if predictor != 1:
        entries.append((PREDICTOR, 3, [predictor]))
    if colormap is not None:
        entries.append((COLORMAP, 3, np.asarray(colormap).reshape(-1).tolist()))
    if extra_samples is not None:
        entries.append((EXTRA_SAMPLES, 3, [extra_samples]))
    entries += [(t, k, list(v)) for t, k, v in extra_tags]
    entries.sort(key=lambda e: e[0])
    ifd_at = len(body)
    tail = bytearray()  # values too long for their entry, after the IFD
    tail_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd = bytearray(struct.pack(bo + "H", len(entries)))
    for tag, kind, values in entries:
        code, size = _TYPES[kind]
        packed = struct.pack(f"{bo}{len(values)}{code}", *values)
        if len(packed) <= 4:
            ifd += struct.pack(bo + "HHI", tag, kind, len(values)) + packed.ljust(4, b"\x00")
        else:
            ifd += struct.pack(bo + "HHII", tag, kind, len(values), tail_at + len(tail))
            tail += packed
            if len(tail) % 2:
                tail.append(0)
    ifd += bytes(4)
    body[4:8] = struct.pack(bo + "I", ifd_at)
    return bytes(body + ifd + tail)
