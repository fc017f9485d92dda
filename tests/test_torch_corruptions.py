"""The port's image corruptions (``rsprompter_tpu_torch/data/corruptions.py``)
against the JAX package's ``corrupt``, which calls OpenCV.

- All ten corruptions at severities 1, 3 and 5, on the same float32 image
  (odd sizes, so that OpenCV's borders, its INTER_AREA weights at a
  fractional ratio and the JPEG encoder's edge blocks are all reached) and
  the same seed: within 1e-3 of the 255 scale, ``jpeg_compression`` and the
  noise corruptions (numpy's draws) exactly. The port runs with
  ``sys.modules['cv2'] = None``: it never imports OpenCV. A uint8 input
  keeps its dtype, as JAX's does.
- ``filter2d``, ``warp_affine`` and ``resize_area`` against ``cv2.filter2D``
  (direct and DFT-sized kernels, an image narrower than the kernel),
  ``cv2.warpAffine`` and ``cv2.resize(INTER_AREA)`` at integral and
  fractional ratios.
- ``CorruptImage`` takes the raw sample's image as float32, seeded by
  ``img_id``, as JAX's pipeline step does on JAX's float32 image.
- An unknown corruption or a severity out of 1..5 raises ``ValueError``.
"""

import sys

import cv2
import numpy as np
import pytest

from rsprompter_tpu.data.corruptions import CORRUPTIONS as JAX_CORRUPTIONS
from rsprompter_tpu.data.corruptions import CorruptImage as JaxCorruptImage
from rsprompter_tpu.data.corruptions import corrupt as jax_corrupt
from rsprompter_tpu_torch.data import corruptions as port

TOL = 1e-3  # of the 255 scale
EXACT = {"gaussian_noise", "shot_noise", "impulse_noise", "brightness", "contrast",
         "jpeg_compression"}


def _image(seed, h=61, w=83, dtype=np.float32):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, 3))
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(field + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(dtype)


@pytest.mark.parametrize("name", port.CORRUPTIONS)
def test_corrupt_matches_jax(name, monkeypatch):
    assert port.CORRUPTIONS == JAX_CORRUPTIONS
    img = _image(1)
    refs = {s: jax_corrupt(img, name, s, seed=7) for s in (1, 3, 5)}
    monkeypatch.setitem(sys.modules, "cv2", None)
    for s, ref in refs.items():
        got = port.corrupt(img, name, s, seed=7)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        diff = np.abs(got.astype(np.float64) - ref)
        if name in EXACT:
            assert diff.max() == 0, (name, s)
        else:
            assert diff.max() <= TOL, (name, s, diff.max())


def test_uint8_input_keeps_its_dtype():
    img = _image(2, 40, 50, np.uint8)
    for name in ("gaussian_noise", "pixelate", "jpeg_compression"):
        ref = jax_corrupt(img, name, 2, seed=3)
        got = port.corrupt(img, name, 2, seed=3)
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name


@pytest.mark.parametrize("size,k", [((30, 40), 7), ((30, 40), 21), ((12, 9), 19)])
def test_filter2d_matches_cv2(size, k):
    rng = np.random.default_rng(k)
    x = rng.uniform(0, 1, (*size, 3)).astype(np.float32)
    kernel = rng.uniform(0, 1, (k, k)).astype(np.float32)
    kernel /= kernel.sum()
    ref = cv2.filter2D(x, -1, kernel)
    np.testing.assert_allclose(port.filter2d(x, kernel), ref, atol=2e-6)


@pytest.mark.parametrize("p", [9, 11, 13, 15, 19])
def test_motion_kernel_matches_warp_affine(p):
    k = np.zeros((p, p), np.float32)
    k[p // 2, :] = 1.0 / p
    c, s = np.cos(np.deg2rad(25)), np.sin(np.deg2rad(25))
    m = np.float32([[c, -s, p / 2 * (1 - c + s)], [s, c, p / 2 * (1 - s - c)]])
    np.testing.assert_allclose(port.warp_affine(k, m), cv2.warpAffine(k, m, (p, p)),
                               atol=1e-6)


@pytest.mark.parametrize("src,dst", [((64, 48), (32, 24)), ((61, 83), (36, 49)),
                                     ((61, 83), (15, 20)), ((7, 9), (1, 2))])
def test_resize_area_matches_cv2(src, dst):
    x = np.random.default_rng(0).uniform(0, 1, (*src, 3)).astype(np.float32)
    ref = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(port.resize_area(x, dst), ref, atol=1e-6)


def test_corrupt_image_step_matches_jax():
    img = _image(4, 50, 70, np.uint8)
    ours = port.CorruptImage("gaussian_noise", 3)({"img": img, "img_id": 12})
    ref = JaxCorruptImage("gaussian_noise", 3)({"img": img.astype(np.float32), "img_id": 12})
    assert ours["img"].dtype == np.float32
    np.testing.assert_array_equal(ours["img"], ref["img"])


def test_refusals():
    img = _image(5, 8, 8)
    with pytest.raises(ValueError, match="fog"):
        port.corrupt(img, "fog")
    with pytest.raises(ValueError, match="severity"):
        port.corrupt(img, "brightness", 6)
    with pytest.raises(ValueError, match="snow"):
        port.CorruptImage("snow")
