"""The port's JPEG decoder (``rsprompter_tpu_torch/data/jpeg.py``) against
``cv2.imread``, byte for byte.

- Seeded images written here with ``cv2.imencode`` (libjpeg-turbo): 4:4:4,
  4:2:2, 4:2:0, 4:4:0, 4:1:1 and grey; qualities 50, 75 and 95; sizes from
  1 x 1 to 601 x 957, none a multiple of the MCU; restart intervals;
  optimised Huffman tables; SOF1 and 16-bit DQT entries made by rewriting a
  baseline file's markers; the EXIF orientations 1-8. Every array equals
  OpenCV's exactly.
- The committed fixtures of ``tests/data/jpeg/`` decode to the sha256 in
  ``digests.json`` (``cv2.imread``'s, written by
  ``scripts/make_jpeg_fixtures.py``), also with OpenCV hidden.
- A progressive file raises naming SOF2; truncated data raises; a file that
  is no JPEG raises.
- Malformed headers that OpenCV also refuses raise ``ValueError``: Huffman
  counts that are no prefix code, and a frame of more than 2^30 pixels.
  Seeded byte flips over encoded files either decode to the frame's shape
  or raise ``ValueError``.
- ``data.io``: ``imread`` and ``decode_image`` route JPEG to the port's
  decoder, never to OpenCV; ``encode_png`` writes what OpenCV reads back.
"""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from rsprompter_tpu_torch.data.io import decode_image, encode_png, imread
from rsprompter_tpu_torch.data.jpeg import decode_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}


def _image(rng, h, w, c=3):
    """A blocky field plus noise: edges inside and across blocks."""
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, c))
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    img = np.clip(field + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)
    return img[:, :, 0] if c == 1 else img


def _encode(img, quality=90, sampling="420", restart=0, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _assert_like_cv2(data: bytes):
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = decode_jpeg(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


CASES = [(s, q, hw) for s in ("444", "422", "420", "grey") for q in (50, 75, 95)
         for hw in ((37, 53), (601, 957))]


@pytest.mark.parametrize("sampling,quality,hw", CASES)
def test_equals_cv2(sampling, quality, hw):
    rng = np.random.default_rng(CASES.index((sampling, quality, hw)))
    img = _image(rng, *hw, c=1 if sampling == "grey" else 3)
    _assert_like_cv2(_encode(img, quality, sampling if sampling != "grey" else "444"))


@pytest.mark.parametrize("sampling,hw,restart", [
    ("420", (1, 1), 0), ("420", (2, 3), 0), ("422", (17, 2), 0), ("420", (9, 31), 1),
    ("422", (64, 48), 3), ("420", (123, 77), 4), ("444", (40, 70), 7), ("440", (37, 53), 0),
    ("440", (50, 33), 2), ("411", (37, 53), 0), ("411", (29, 67), 5)])
def test_edges_sampling_and_restarts_equal_cv2(sampling, hw, restart):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    _assert_like_cv2(_encode(_image(rng, *hw), 85, sampling, restart))


def test_optimised_tables_sof1_and_16_bit_quantisation_equal_cv2():
    rng = np.random.default_rng(7)
    img = _image(rng, 96, 130)
    _assert_like_cv2(_encode(img, 60, "420", IMWRITE_JPEG_OPTIMIZE=1))
    data = bytearray(_encode(img, 90, "422"))
    sof = data.find(b"\xff\xc0")
    data[sof + 1] = 0xC1  # extended sequential, 8-bit: decoded as baseline
    _assert_like_cv2(bytes(data))
    # every DQT entry rewritten as 16 bits (Pq = 1), same values
    out, p = bytearray(data[:2]), 2
    while True:
        marker, length = data[p + 1], struct.unpack(">H", data[p + 2:p + 4])[0]
        seg = data[p + 4:p + 2 + length]
        if marker == 0xDB:
            wide = bytearray()
            for j in range(0, len(seg), 65):
                wide += bytes([0x10 | (seg[j] & 15)])
                wide += b"".join(struct.pack(">H", v) for v in seg[j + 1:j + 65])
            out += b"\xff\xdb" + struct.pack(">H", len(wide) + 2) + wide
        else:
            out += data[p:p + 2 + length]
        p += 2 + length
        if marker == 0xDA:
            out += data[p:]
            break
    assert out != data
    _assert_like_cv2(bytes(out))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_imread(tmp_path, orientation):
    rng = np.random.default_rng(orientation)
    data = _encode(_image(rng, 40, 70), 90, "420")
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHII", 0x0112, 3, 1, orientation) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]
    path = tmp_path / "o.jpg"
    path.write_bytes(data)
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imread(str(path)), ref)


with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_match_digests_without_opencv(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the card's machine has no OpenCV
    img = imread(os.path.join(FIXTURES, name))
    assert list(img.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


def test_fixture_digests_are_cv2s():
    for name, want in DIGESTS.items():
        ref = cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"], name


def test_refusals_name_the_file_and_marker(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # no fallback to try
    rng = np.random.default_rng(3)
    img = _image(rng, 48, 64)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = tmp_path / "prog.jpg"
    path.write_bytes(prog.tobytes())
    with pytest.raises(ValueError, match=r"prog\.jpg: .*SOF2 \(progressive\)"):
        imread(str(path))
    data = _encode(img, 90, "420")
    for cut in (len(data) - 2, len(data) - 40, len(data) // 2, 200):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            imread(str(path))
    arith = bytearray(data)
    arith[arith.find(b"\xff\xc0") + 1] = 0xC9
    with pytest.raises(ValueError, match="SOF9"):
        decode_jpeg(bytes(arith))
    twelve = bytearray(data)
    twelve[twelve.find(b"\xff\xc0") + 4] = 12  # sample precision
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(bytes(twelve))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x00\x01garbage")


def _cv2_refuses(data: bytes) -> bool:
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    except cv2.error:
        return True


def _with_dht(data: bytes, counts) -> bytes:
    """``data`` with its DC table 0 redefined by ``counts`` (16 code-length
    counts) just before SOS, so that the scan uses it."""
    seg = bytes([0x00, *counts]) + bytes(range(256))[:sum(counts)]
    sos = data.find(b"\xff\xda")
    return data[:sos] + b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg + data[sos:]


@pytest.mark.parametrize("counts", [
    [3] + [0] * 15,                 # three 1-bit codes
    [0, 5] + [0] * 14,              # five 2-bit codes
    [255] + [0] * 15,               # far past the 9-bit lookup table
    [2] + [0] * 15,                 # the all-ones 1-bit code
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2],  # a 16-bit all-ones code
], ids=["1bit_x3", "2bit_x5", "1bit_x255", "all_ones_1bit", "all_ones_16bit"])
def test_bad_huffman_counts_raise(counts):
    data = _with_dht(_encode(_image(np.random.default_rng(11), 16, 16), 90, "420"), counts)
    assert _cv2_refuses(data)
    with pytest.raises(ValueError, match=r"bad\.jpg: bad Huffman table \(DHT\)"):
        decode_jpeg(data, "bad.jpg")


def test_frames_past_opencvs_pixel_limit_raise():
    data = bytearray(_encode(_image(np.random.default_rng(12), 16, 16), 90, "420"))
    at = data.find(b"\xff\xc0") + 5
    for h, w in ((65535, 65535), (32768, 32769)):
        data[at:at + 4] = struct.pack(">HH", h, w)
        assert _cv2_refuses(bytes(data))
        with pytest.raises(ValueError, match=r"huge\.jpg: .*more than 2\^30"):
            decode_jpeg(bytes(data), "huge.jpg")


@pytest.mark.parametrize("sampling,restart", [("420", 0), ("422", 2), ("grey", 0)])
def test_byte_flips_decode_or_raise(sampling, restart):
    rng = np.random.default_rng({"420": 21, "422": 22, "grey": 23}[sampling])
    img = _image(rng, 24, 40, c=1 if sampling == "grey" else 3)
    data = _encode(img, 75, "444" if sampling == "grey" else sampling, restart)
    sos = data.find(b"\xff\xda")
    for trial in range(300):
        bad = bytearray(data)
        # half the flips land in the headers (DQT, SOF, DHT, SOS), half anywhere
        end = sos + 14 if trial % 2 else len(bad)
        for at in rng.integers(2, end, size=int(rng.integers(1, 4))):
            bad[at] = int(rng.integers(0, 256))
        try:
            out = decode_jpeg(bytes(bad))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


def test_decode_image_and_encode_png(monkeypatch):
    rng = np.random.default_rng(5)
    img = _image(rng, 37, 53)
    png = encode_png(img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(png, np.uint8), 1), img)
    jpg = _encode(img, 80, "420")
    ref = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(decode_image(png), img)
    np.testing.assert_array_equal(decode_image(jpg), ref)
    with pytest.raises(ValueError, match="not a PNG, JPEG"):
        decode_image(b"GIF89a....")
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))
