"""Write the PNG and TIFF fixtures of ``tests/data/formats/`` and their digests.

    python scripts/make_image_format_fixtures.py [--out tests/data/formats] [--seed 0]

Small seeded images (a smooth field with blocks and noise, so that every
filter, run and code width has work) in each form ``data/io.py`` decodes
beside 8-bit PNG and baseline JPEG:

- PNG: grey at 1, 2, 4 and 16 bits, palette at 1, 2, 4 and 8 bits (with and
  without ``tRNS``), grey + alpha, RGB and RGBA at 16 bits, each of these
  also Adam7-interlaced, colour PNGs with ``gAMA`` and ``sRGB`` (their grey
  read goes through libpng's gamma tables), every row filter in turn;
- TIFF: ``II`` and ``MM``; strips (``RowsPerStrip`` given and missing) and
  tiles that overhang the image; no compression, PackBits (with no-op
  bytes) and LZW with predictor 1 and 2 (one strip long enough for 12-bit
  codes and a Clear at a full table); photometric 0-3; 1-, 8- and 16-bit
  samples; 1, 3 and 4 samples a pixel (ExtraSamples 0, 1 and 2).

OpenCV writes none of these as made here, so they are written by this
script (PNG) and by ``data/tiff.py``'s ``encode_tiff``, and decoded by
``cv2.imread``. ``digests.json`` holds, for each fixture and for the JPEG
fixtures of ``tests/data/jpeg/`` (keys relative to ``tests/data``), the
sha256 and shape of ``cv2.imread(path, IMREAD_COLOR)`` and
``IMREAD_GRAYSCALE``: the bytes the port must give, on a machine without
OpenCV too (``tests/test_torch_image_formats.py``, ``chip_smoke.py``'s WHU
phase). Needs OpenCV; run it where OpenCV is installed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from rsprompter_tpu_torch.data import tiff  # noqa: E402
from rsprompter_tpu_torch.data.io import ADAM7, PNG_SIGNATURE  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "data")


def field(rng, h: int, w: int, ch: int, top: int) -> np.ndarray:
    """Seeded samples in [0, top]: blocks of a coarse field, rectangles, noise."""
    coarse = rng.uniform(0, top, (h // 8 + 2, w // 8 + 2, ch))
    img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    for _ in range(4):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + int(rng.integers(1, h // 2 + 2)), x:x + int(rng.integers(1, w // 2 + 2))] = \
            rng.uniform(0, top, ch)
    img = img + rng.normal(0, top / 40, img.shape)
    return np.clip(np.rint(img), 0, top).astype(np.int64)


# --- PNG -------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, n) samples -> (rows, stride) bytes, big-endian, MSB first."""
    rows = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(rows, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, -samples.shape[1] % per))).reshape(rows, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (s << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """Each row under filter (first_kind + y) % 5: every filter in turn."""
    r = rows.astype(np.int64)
    out, prev = [], np.zeros(r.shape[1], np.int64)
    for y, cur in enumerate(r):
        kind = (first_kind + y) % 5
        a = np.r_[np.zeros(bpp, np.int64), cur[:-bpp]][:cur.size]
        c = np.r_[np.zeros(bpp, np.int64), prev[:-bpp]][:cur.size]
        pred = {0: 0, 1: a, 2: prev, 3: (a + prev) // 2}.get(kind)
        if kind == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def png(img: np.ndarray, depth: int, colour: int, interlace: int = 0, palette=None,
        trns: bytes = None, extra: bytes = b"") -> bytes:
    h, w, ch = img.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for i, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, i)
    z = zlib.compress(raw, 9)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)) + extra
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    half = len(z) // 2  # two IDAT chunks
    return (PNG_SIGNATURE + body + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
            + _chunk(b"IEND", b""))


def png_fixtures(rng) -> dict:
    out = {}
    h, w = 27, 35
    for il in (0, 1):
        tag = "_adam7" if il else ""
        for depth in (1, 2, 4, 16):
            out[f"grey{depth}{tag}.png"] = png(field(rng, h, w, 1, (1 << depth) - 1), depth, 0, il)
        for depth in (1, 2, 4, 8):
            n = 1 << depth
            pal = rng.integers(0, 256, (n, 3))
            idx = field(rng, h, w, 1, n - 1)
            out[f"palette{depth}{tag}.png"] = png(idx, depth, 3, il, palette=pal)
            trns = rng.integers(0, 256, max(1, n // 2)).astype(np.uint8).tobytes()
            out[f"palette{depth}_trns{tag}.png"] = png(idx, depth, 3, il, palette=pal, trns=trns)
        for colour, ch, name in ((4, 2, "grey_alpha"), (2, 3, "rgb"), (6, 4, "rgba")):
            out[f"{name}16{tag}.png"] = png(field(rng, h, w, ch, 65535), 16, colour, il)
        out[f"grey8{tag}.png"] = png(field(rng, h, w, 1, 255), 8, 0, il)
        out[f"rgb8{tag}.png"] = png(field(rng, h, w, 3, 255), 8, 2, il)
    for hw in ((1, 1), (3, 2), (1, 9), (9, 1)):  # Adam7's empty passes
        out[f"rgb8_adam7_{hw[0]}x{hw[1]}.png"] = png(field(rng, *hw, 3, 255), 8, 2, 1)
    gamma = _chunk(b"gAMA", struct.pack(">I", 45455))
    out["rgb8_gama.png"] = png(field(rng, h, w, 3, 255), 8, 2, extra=gamma)
    out["palette8_srgb.png"] = png(field(rng, h, w, 1, 255), 8, 3,
                                   palette=rng.integers(0, 256, (256, 3)),
                                   extra=_chunk(b"sRGB", b"\x00"))
    out["rgb8_gama_near_1.png"] = png(field(rng, h, w, 3, 255), 8, 2,
                                      extra=_chunk(b"gAMA", struct.pack(">I", 104000)))
    return out


# --- TIFF ------------------------------------------------------------------


PACKBITS = tiff.packbits


def packbits_with_noops(row: bytes) -> bytes:
    """PackBits with a no-op header byte (128) before every row."""
    return b"\x80" + PACKBITS(row)


def tiff_fixtures(rng) -> dict:
    out = {}
    h, w = 29, 37
    rgb = field(rng, h, w, 3, 255)
    for bo, tag in (("<", "ii"), (">", "mm")):
        for comp, cname in ((tiff.NONE, "none"), (tiff.PACKBITS, "packbits"), (tiff.LZW, "lzw")):
            out[f"rgb8_{tag}_{cname}_strips.tif"] = tiff.encode_tiff(
                rgb, tiff.RGB, compression=comp, byteorder=bo, rows_per_strip=8)
            out[f"rgb8_{tag}_{cname}_tiles.tif"] = tiff.encode_tiff(
                rgb, tiff.RGB, compression=comp, byteorder=bo, tile=(16, 16))
        out[f"rgb8_{tag}_lzw_pred2.tif"] = tiff.encode_tiff(
            rgb, tiff.RGB, compression=tiff.LZW, predictor=2, byteorder=bo, rows_per_strip=16)
        out[f"rgb16_{tag}_lzw_pred2_tiles.tif"] = tiff.encode_tiff(
            field(rng, h, w, 3, 65535), tiff.RGB, bits=16, compression=tiff.LZW, predictor=2,
            byteorder=bo, tile=(16, 32))
        out[f"grey16_{tag}_none.tif"] = tiff.encode_tiff(
            field(rng, h, w, 1, 65535), tiff.MIN_IS_BLACK, bits=16, byteorder=bo)
    out["rgb8_one_strip.tif"] = tiff.encode_tiff(rgb, tiff.RGB)  # no RowsPerStrip
    big = field(rng, 64, 72, 3, 255)  # one LZW strip: 12-bit codes, then a Clear
    out["rgb8_lzw_long_strip.tif"] = tiff.encode_tiff(
        (big + rng.integers(0, 64, big.shape)) % 256, tiff.RGB, compression=tiff.LZW)
    grey = field(rng, h, w, 1, 255)
    out["grey8_minisblack_lzw_pred2.tif"] = tiff.encode_tiff(
        grey, tiff.MIN_IS_BLACK, compression=tiff.LZW, predictor=2, rows_per_strip=10)
    out["grey8_miniswhite_packbits.tif"] = tiff.encode_tiff(
        grey, tiff.MIN_IS_WHITE, compression=tiff.PACKBITS, rows_per_strip=7)
    out["grey16_miniswhite_lzw.tif"] = tiff.encode_tiff(
        field(rng, h, w, 1, 65535), tiff.MIN_IS_WHITE, bits=16, compression=tiff.LZW)
    bits1 = field(rng, h, w, 1, 1)
    out["bilevel_minisblack_tiles.tif"] = tiff.encode_tiff(bits1, tiff.MIN_IS_BLACK, bits=1,
                                                           tile=(16, 16))
    out["bilevel_miniswhite_packbits.tif"] = tiff.encode_tiff(
        bits1, tiff.MIN_IS_WHITE, bits=1, compression=tiff.PACKBITS, byteorder=">")
    out["palette8_lzw.tif"] = tiff.encode_tiff(
        field(rng, h, w, 1, 255), tiff.PALETTE, compression=tiff.LZW,
        colormap=rng.integers(0, 65536, (3, 256)))
    out["palette8_8bit_colormap.tif"] = tiff.encode_tiff(
        field(rng, h, w, 1, 255), tiff.PALETTE, colormap=rng.integers(0, 256, (3, 256)))
    out["palette1_mm.tif"] = tiff.encode_tiff(bits1, tiff.PALETTE, bits=1, byteorder=">",
                                              colormap=rng.integers(0, 65536, (3, 2)))
    rgba = field(rng, h, w, 4, 255)
    for es, name in ((None, "none"), (0, "unspecified"), (1, "associated"),
                     (2, "unassociated")):
        out[f"rgba8_extrasamples_{name}.tif"] = tiff.encode_tiff(
            rgba, tiff.RGB, compression=tiff.PACKBITS, extra_samples=es, rows_per_strip=9)
    out["rgba16_unassociated_mm_tiles.tif"] = tiff.encode_tiff(
        field(rng, h, w, 4, 65535), tiff.RGB, bits=16, extra_samples=2, byteorder=">",
        tile=(32, 32))
    tiff.packbits = packbits_with_noops
    try:
        out["rgb8_packbits_noops.tif"] = tiff.encode_tiff(rgb, tiff.RGB,
                                                          compression=tiff.PACKBITS)
    finally:
        tiff.packbits = PACKBITS
    return out


def digest(img) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(DATA_DIR, "formats"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    files = {**png_fixtures(rng), **tiff_fixtures(rng)}
    paths = {}
    for name, data in files.items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        paths[f"formats/{name}"] = path
    jpeg_dir = os.path.join(DATA_DIR, "jpeg")
    for name in sorted(os.listdir(jpeg_dir)):
        if name.endswith(".jpg"):
            paths[f"jpeg/{name}"] = os.path.join(jpeg_dir, name)
    digests = {}
    for key, path in sorted(paths.items()):
        entry = {}
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            img = cv2.imread(path, flag)
            if img is None:
                raise SystemExit(f"OpenCV cannot read {path}")
            entry[mode] = digest(img)
        digests[key] = entry
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=0, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total} bytes, in {args.out}")


if __name__ == "__main__":
    main()
