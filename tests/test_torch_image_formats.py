"""The port's PNG, TIFF and JPEG readers against ``cv2.imread``, in colour
and in grey, with OpenCV hidden.

- The fixtures of ``tests/data/formats/`` (``scripts/make_image_format_fixtures.py``:
  PNG palette, 1/2/4/16-bit grey, 16-bit grey + alpha / RGB / RGBA, Adam7
  at every depth, gamma chunks; TIFF ``II`` / ``MM``, strips / tiles, none /
  PackBits / LZW with predictor 1 and 2, photometric 0-3, 1-, 8- and 16-bit,
  1, 3, 4 samples) and the JPEG fixtures: ``data/io.imread`` under
  ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` gives the sha256 that
  ``cv2.imread`` gave when the digests were written, and equals
  ``cv2.imread`` here byte for byte.
- Seeded JPEGs of each sampling read in grey equal ``cv2.imread``'s.
- TIFF and PNG never reach OpenCV; a tag value outside the decoded forms,
  BigTIFF and data cut short raise ``ValueError`` naming the fault.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from rsprompter_tpu_torch.data import tiff
from rsprompter_tpu_torch.data.io import (IMREAD_COLOR, IMREAD_GRAYSCALE, PNG_SIGNATURE,
                                          decode_image, decode_png, imread)

DATA = os.path.join(os.path.dirname(__file__), "data")
DIGESTS = json.load(open(os.path.join(DATA, "formats", "digests.json")))
FIXTURES = sorted(DIGESTS)
MODES = {"color": IMREAD_COLOR, "gray": IMREAD_GRAYSCALE}


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def test_fixtures_cover_every_form():
    names = {k.split("/", 1)[1] for k in FIXTURES}
    for want in ("palette1.png", "palette4_trns_adam7.png", "grey2.png", "grey16_adam7.png",
                 "rgba16.png", "grey_alpha16_adam7.png", "rgb8_mm_lzw_tiles.tif",
                 "rgb8_ii_packbits_strips.tif", "rgb8_ii_lzw_pred2.tif",
                 "rgb16_mm_lzw_pred2_tiles.tif", "grey8_miniswhite_packbits.tif",
                 "bilevel_minisblack_tiles.tif", "palette8_lzw.tif", "grey16_ii_none.tif",
                 "rgba8_extrasamples_unassociated.tif", "rgb8_one_strip.tif",
                 "rgb8_lzw_long_strip.tif", "rgb8_packbits_noops.tif", "scene_420_q95.jpg"):
        assert want in names, want
    total = sum(os.path.getsize(os.path.join(DATA, "formats", n))
                for n in os.listdir(os.path.join(DATA, "formats")))
    assert total < 300_000


@pytest.mark.parametrize("key", FIXTURES)
def test_fixture_equals_cv2_without_opencv(key, monkeypatch):
    path = os.path.join(DATA, key)
    refs = {mode: cv2.imread(path, flag) for mode, flag in MODES.items()}
    monkeypatch.setitem(sys.modules, "cv2", None)  # a machine without OpenCV
    for mode, flag in MODES.items():
        got = imread(path, flag)
        assert got.dtype == np.uint8
        assert list(got.shape) == DIGESTS[key][mode]["shape"], mode
        assert _sha(got) == DIGESTS[key][mode]["sha256"], mode
        np.testing.assert_array_equal(got, refs[mode])
        if not key.endswith(".jpg"):  # the bytes too, the path the server takes
            with open(path, "rb") as f:
                np.testing.assert_array_equal(decode_image(f.read(), flag), got)


def _jpeg(img, sampling):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 83,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("sampling", [0x411111, 0x221111, 0x211111, 0x111111, 0x121111])
def test_jpeg_grey_read_equals_cv2(sampling, tmp_path):
    rng = np.random.default_rng(sampling % 97)
    for h, w in ((37, 53), (64, 64), (17, 9)):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(np.uint8), (5, 5), 1.5)
        path = tmp_path / f"{h}x{w}.jpg"
        path.write_bytes(_jpeg(img, sampling))
        for flag in (IMREAD_COLOR, IMREAD_GRAYSCALE):
            np.testing.assert_array_equal(imread(str(path), flag), cv2.imread(str(path), flag))


def test_tiff_and_png_never_reach_opencv(tmp_path, monkeypatch):
    class NoOpenCV:  # OpenCV imports, but must not be asked
        def __getattr__(self, name):
            raise AssertionError(f"cv2.{name} was reached")

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    (tmp_path / "a.tif").write_bytes(tiff.encode_tiff(img[:, :, ::-1], tiff.RGB,
                                                      compression=tiff.LZW))
    ref = cv2.imread(str(tmp_path / "a.tif"))
    monkeypatch.setitem(sys.modules, "cv2", NoOpenCV())
    np.testing.assert_array_equal(imread(str(tmp_path / "a.tif")), ref)
    np.testing.assert_array_equal(ref, img)
    bad = tiff.encode_tiff(img, tiff.RGB, extra_tags=[(tiff.ORIENTATION, 3, [3])])
    (tmp_path / "b.tif").write_bytes(bad)
    with pytest.raises(ValueError, match=r"Orientation \(tag 274\) = 3"):
        imread(str(tmp_path / "b.tif"))  # raises; never handed to OpenCV
    with pytest.raises(ValueError, match="imread flags"):
        imread(str(tmp_path / "a.tif"), 2)


def _patch_tag(data: bytes, tag: int, value: int) -> bytes:
    """The TIFF with one SHORT / LONG tag's first value replaced."""
    bo = "<" if data[:2] == b"II" else ">"
    (pos,) = struct.unpack(bo + "I", data[4:8])
    (n,) = struct.unpack(bo + "H", data[pos:pos + 2])
    out = bytearray(data)
    for i in range(n):
        at = pos + 2 + 12 * i
        t, kind, count = struct.unpack(bo + "HHI", data[at:at + 8])
        if t == tag:
            packed = struct.pack(bo + ("H" if kind == 3 else "I"), value)
            out[at + 8:at + 12] = packed.ljust(4, b"\0")
            return bytes(out)
    raise KeyError(tag)


@pytest.mark.parametrize("tag,value,what", [
    (tiff.COMPRESSION, 7, r"Compression \(tag 259\) = 7"),
    (tiff.PHOTOMETRIC, 6, r"PhotometricInterpretation \(tag 262\) = 6"),
    (tiff.PLANAR, 2, r"PlanarConfiguration \(tag 284\) = 2"),
    (tiff.PREDICTOR, 3, r"Predictor \(tag 317\) = 3"),
    (tiff.SAMPLES, 2, r"SamplesPerPixel \(tag 277\) = 2"),
    (tiff.BITS, 4, r"BitsPerSample \(tag 258\) = \(4,\)"),
])
def test_tiff_refuses_other_tag_values(tag, value, what):
    grey = np.arange(60, dtype=np.uint8).reshape(6, 10)
    data = tiff.encode_tiff(grey, tiff.MIN_IS_BLACK, predictor=2)
    with pytest.raises(ValueError, match=what):
        tiff.decode_tiff(_patch_tag(data, tag, value))


def test_tiff_refuses_sample_format_bigtiff_and_short_data():
    img = np.random.default_rng(1).integers(0, 256, (24, 33, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match=r"SampleFormat \(tag 339\) = \(3, 3, 3\)"):
        tiff.decode_tiff(tiff.encode_tiff(img, tiff.RGB, extra_tags=[(tiff.SAMPLE_FORMAT, 3,
                                                                      [3, 3, 3])]))
    with pytest.raises(ValueError, match="BigTIFF"):
        tiff.decode_tiff(b"II+\x00" + bytes(12))
    for comp in (tiff.NONE, tiff.PACKBITS, tiff.LZW):
        data = tiff.encode_tiff(img, tiff.RGB, compression=comp)
        bo, tags = tiff._ifd(data, "x")
        off, n = tags[tiff.STRIP_OFFSETS][0], tags[tiff.STRIP_BYTES][0]
        cut = _patch_tag(data, tiff.STRIP_BYTES, n // 2)  # the strip's data end early
        with pytest.raises(ValueError, match="data end after"):
            tiff.decode_tiff(cut)
        with pytest.raises(ValueError, match="past the end of the file"):
            tiff.decode_tiff(data[:off + n // 2])  # the file ends inside the strip
    with pytest.raises(ValueError, match="past the end of the file"):
        tiff.decode_tiff(tiff.encode_tiff(img, tiff.RGB)[:60])  # cut inside the IFD
    with pytest.raises(ValueError, match="corrupt LZW data: code 511"):
        tiff._decompress(tiff.LZW, bytes([0x80, 0x7F, 0xFF, 0xF0]), 10, "x")


def test_lzw_and_packbits_codecs_round_trip():
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 300, 5000, 40000):  # past 511, 1023, 2047 codes and a Clear
        data = (rng.integers(0, 4, n) * 60).astype(np.uint8).tobytes() if n % 2 else \
            rng.integers(0, 256, n).astype(np.uint8).tobytes()
        for comp, enc in ((tiff.LZW, tiff.lzw), (tiff.PACKBITS, tiff.packbits)):
            if n:
                assert tiff._decompress(comp, enc(data), n, "x").tobytes() == data


def _png(w, h, depth, colour, raw_rows: bytes, extra=b""):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + extra + chunk(b"IDAT", zlib.compress(raw_rows)) + chunk(b"IEND", b""))


def test_png_refusals():
    with pytest.raises(ValueError, match="colour type 5"):
        decode_png(_png(2, 2, 8, 5, bytes(10)))
    with pytest.raises(ValueError, match="bit depth 16, colour type 3"):
        decode_png(_png(2, 2, 16, 3, bytes(10)))
    with pytest.raises(ValueError, match="end inside the image"):
        decode_png(_png(4, 4, 8, 2, bytes(20)))
    whole = _png(4, 4, 8, 2, bytes(4 * 13))
    with pytest.raises(ValueError, match="do not inflate"):  # the file cut inside its IDAT
        decode_png(whole[:whole.index(b"IDAT") + 10])
    with pytest.raises(ValueError, match="without PLTE"):
        decode_png(_png(2, 2, 8, 3, bytes(6)))
    gama = (struct.pack(">I", 4) + b"gAMA" + struct.pack(">I", 45455)
            + struct.pack(">I", zlib.crc32(b"gAMA" + struct.pack(">I", 45455)) & 0xFFFFFFFF))
    data = _png(2, 2, 16, 2, bytes(2 * (1 + 12)), gama)
    assert decode_png(data).shape == (2, 2, 3)  # colour: no gamma involved
    with pytest.raises(ValueError, match="16-bit gamma"):
        decode_png(data, gray=True)
