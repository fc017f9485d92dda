"""The port's JPEG encoder (``rsprompter_tpu_torch/data/jpeg.py``
``encode_jpeg``) against ``cv2.imencode``, byte for byte.

- Seeded random images of odd sizes from 1 x 1 to 67 x 131 (none a
  multiple of the 16-pixel MCU, so edge replication and the dummy blocks
  past the image are exercised) and smooth ones, at qualities 1, 7, 10, 25,
  50, 75, 95 and 100 (forced baseline clamps the tables at 255 below 50):
  every file equals OpenCV's.
- The committed fixtures of ``tests/data/jpeg/``, decoded, encode at
  qualities 95 and 7 to the sha256 in ``encode_digests.json``
  (``scripts/make_jpeg_encode_fixtures.py``, from ``cv2.imencode``), also
  with OpenCV hidden, and the encoded files decode through the port's
  decoder as OpenCV decodes them.
- ``data.io.imwrite`` writes ``.jpg`` through the encoder at OpenCV's
  default quality 95 and ``.png`` through ``encode_png``; ``drawn_name``
  keeps a written format's name.
- Grey, 4-channel, non-uint8 input and qualities outside 1..100 raise
  ``ValueError``.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest

from rsprompter_tpu_torch.data.io import decode_png, drawn_name, imwrite
from rsprompter_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
QUALITIES = (1, 7, 10, 25, 50, 75, 95, 100)
SIZES = ((1, 1), (1, 9), (7, 1), (2, 3), (8, 8), (9, 17), (16, 16), (17, 15), (31, 33),
         (45, 60), (64, 48), (67, 131))


def _cv2_bytes(img, quality):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _images(seed):
    """Noise, and a smooth field with edges, at each size."""
    rng = np.random.default_rng(seed)
    for h, w in SIZES:
        yield f"noise{h}x{w}", rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([(xx * 255 / max(w - 1, 1)), (yy * 255 / max(h - 1, 1)),
                           ((xx + yy) % 23) * 11], -1)
        yield f"smooth{h}x{w}", np.clip(smooth + rng.normal(0, 2, smooth.shape),
                                        0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", QUALITIES)
def test_bytes_equal_cv2(quality):
    for name, img in _images(quality):
        assert encode_jpeg(img, quality) == _cv2_bytes(img, quality), name


def test_fixtures_match_digests(monkeypatch):
    with open(os.path.join(FIXTURES, "encode_digests.json")) as f:
        digests = json.load(f)
    assert len(digests) == 4
    images = {name: cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)
              for name in digests}
    monkeypatch.setitem(sys.modules, "cv2", None)  # the card's machine has no OpenCV
    encoded = {}
    for name, entry in digests.items():
        img = images[name]
        assert list(img.shape) == entry["shape"]
        for q in ("95", "7"):
            data = encode_jpeg(img, int(q))
            assert len(data) == entry[q]["bytes"], (name, q)
            assert hashlib.sha256(data).hexdigest() == entry[q]["sha256"], (name, q)
            encoded[name, q] = data
    monkeypatch.undo()
    for (name, q), data in encoded.items():
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(decode_jpeg(data), ref, err_msg=f"{name} q{q}")


def test_imwrite_formats_and_names(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (21, 34, 3), dtype=np.uint8)
    imwrite(str(tmp_path / "a.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == _cv2_bytes(img, 95)
    imwrite(str(tmp_path / "b.JPEG"), img, quality=30)
    assert (tmp_path / "b.JPEG").read_bytes() == _cv2_bytes(img, 30)
    imwrite(str(tmp_path / "c.png"), img)
    np.testing.assert_array_equal(decode_png((tmp_path / "c.png").read_bytes()), img)
    with pytest.raises(ValueError, match="tif"):
        imwrite(str(tmp_path / "d.tif"), img)
    assert [drawn_name(p) for p in ("x/a.jpg", "b.JPEG", "/c.png", "d.tif", "e.npy")] == [
        "a.jpg", "b.JPEG", "c.png", "d.png", "e.png"]


@pytest.mark.parametrize("img,quality", [
    (np.zeros((8, 8), np.uint8), 90),  # grey
    (np.zeros((8, 8, 4), np.uint8), 90),  # BGRA
    (np.zeros((8, 8, 3), np.float32), 90),  # not uint8
    (np.zeros((0, 8, 3), np.uint8), 90),  # empty
    (np.zeros((8, 8, 3), np.uint8), 0),
    (np.zeros((8, 8, 3), np.uint8), 101),
    (np.zeros((8, 8, 3), np.uint8), 50.5),
])
def test_refused_inputs_raise(img, quality):
    with pytest.raises(ValueError):
        encode_jpeg(img, quality)
