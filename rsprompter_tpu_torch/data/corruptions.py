"""Image corruptions for the robustness benchmark, on the host, without OpenCV.

Counterpart of ``rsprompter_tpu/data/corruptions.py``: the same ten
corruptions of the ``imagecorruptions`` tables (noise, blur and digital
groups; the weather group needs texture files and is left out there too),
the same severity parameters and the same float32 numpy operations in the
same order, with numpy's ``RandomState(seed)`` drawing the noise, so that
a seed gives the JAX package's draws. The card's machine has no OpenCV, so
the calls the JAX module makes to it are rebuilt here:

- ``cv2.filter2D(x, -1, k)``: a correlation with the kernel centred,
  borders reflected without repeating the edge (``BORDER_REFLECT_101``), in
  float64 then float32 (OpenCV sums in float32 and takes a DFT for large
  kernels: the two agree to about 1e-6 of the [0, 1] scale);
- ``cv2.warpAffine`` of the motion kernel: OpenCV 5's bilinear rule, the
  inverse map evaluated in floating point, zeros outside;
- ``cv2.resize``: ``ops.image.resize_bilinear_cv2`` (INTER_LINEAR),
  OpenCV's INTER_AREA weights (``computeResizeAreaTab``) and its
  INTER_NEAREST index rule;
- ``cv2.imencode`` / ``cv2.imdecode`` at JPEG quality 25 ... 7: the port's
  encoder and decoder (``data/jpeg.py``), which give OpenCV's bytes.

Images are HWC BGR, float32 or uint8 in [0, 255]; a corruption keeps the
shape and returns the input's dtype for an integer input, float32 otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from rsprompter_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from rsprompter_tpu_torch.data.transforms import nearest_index
from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2

# severity-indexed parameters (index 0 = severity 1), the JAX package's
_PARAMS = {
    "gaussian_noise": [0.08, 0.12, 0.18, 0.26, 0.38],  # sigma on [0,1]
    "shot_noise": [60, 25, 12, 5, 3],  # poisson lambda scale
    "impulse_noise": [0.03, 0.06, 0.09, 0.17, 0.27],  # salt&pepper amount
    "defocus_blur": [3, 4, 6, 8, 10],  # disk radius
    "motion_blur": [9, 11, 13, 15, 19],  # line kernel length
    "zoom_blur": [1.11, 1.16, 1.21, 1.26, 1.31],  # max zoom
    "brightness": [0.1, 0.2, 0.3, 0.4, 0.5],  # additive on [0,1]
    "contrast": [0.4, 0.3, 0.2, 0.1, 0.05],  # scale toward the mean
    "pixelate": [0.6, 0.5, 0.4, 0.3, 0.25],  # downscale factor
    "jpeg_compression": [25, 18, 15, 10, 7],  # jpeg quality
}

CORRUPTIONS = tuple(_PARAMS)


def _reflect_101(n: int, pad: int) -> np.ndarray:
    """Source index of each of ``n + 2 * pad`` padded positions under
    OpenCV's ``BORDER_REFLECT_101`` (``borderInterpolate``)."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def filter2d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(x, -1, kernel)`` for an HWC float32 image and an odd
    square kernel: a correlation, anchor at the centre, reflect-101
    borders."""
    h, w, c = x.shape
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    padded = x[_reflect_101(h, ry)][:, _reflect_101(w, rx)]
    inp = torch.from_numpy(np.ascontiguousarray(padded.transpose(2, 0, 1))).double()[None]
    weight = torch.from_numpy(np.asarray(kernel, np.float64))[None, None].expand(c, 1, kh, kw)
    out = torch.nn.functional.conv2d(inp, weight, groups=c)[0]
    return out.permute(1, 2, 0).float().numpy()


def warp_affine(src: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(src, m, src.shape[::-1])`` for a 2-D float32 array:
    OpenCV's inversion of ``m`` in double, then bilinear sampling at each
    output pixel's mapped point, zero outside the source."""
    a = np.asarray(m, np.float64).ravel().copy()
    det = a[0] * a[4] - a[1] * a[3]
    det = 1.0 / det if det != 0 else 0.0
    a[0], a[4] = a[4] * det, a[0] * det
    a[1] *= -det
    a[3] *= -det
    a[2], a[5] = -a[0] * a[2] - a[1] * a[5], -a[3] * a[2] - a[4] * a[5]
    h, w = src.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = a[0] * xx + a[1] * yy + a[2]
    sy = a[3] * xx + a[4] * yy + a[5]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    padded = np.zeros((h + 2, w + 2), np.float64)
    padded[1:-1, 1:-1] = src

    def tap(dy, dx):
        yi, xi = y0 + dy, x0 + dx
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return np.where(inside, padded[np.clip(yi + 1, 0, h + 1), np.clip(xi + 1, 0, w + 1)], 0.0)

    out = ((tap(0, 0) * (1 - fx) + tap(0, 1) * fx) * (1 - fy)
           + (tap(1, 0) * (1 - fx) + tap(1, 1) * fx) * fy)
    return out.astype(np.float32)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of OpenCV's INTER_AREA along one axis
    (``computeResizeAreaTab``, or the exact box of ``resizeAreaFast`` for
    an integral ratio, which the table gives too)."""
    scale = 1.0 / (n_out / n_in)
    wts = np.zeros((n_out, n_in), np.float32)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] = np.float32((s1 - f1) / cell)
        for s in range(s1, s2):
            wts[d, s] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            wts[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return wts


def resize_area(x: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=INTER_AREA)`` of an HWC float32
    image to a smaller ``size`` (h, w)."""
    nh, nw = size
    h, w = x.shape[:2]
    if (nh, nw) == (h, w):
        return x.copy()
    wy = _area_weights(h, nh).astype(np.float64)
    wx = _area_weights(w, nw).astype(np.float64)
    c = x.shape[2]
    out = (wy @ x.astype(np.float64).reshape(h, w * c)).reshape(nh, w, c)
    out = np.matmul(wx, out)  # (nh, nw, c): each output row's columns
    return out.astype(np.float32)


def resize_nearest(x: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=INTER_NEAREST)``."""
    nh, nw = size
    return x[nearest_index(x.shape[0], nh)][:, nearest_index(x.shape[1], nw)]


def resize_linear(x: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(x, (w, h))`` (INTER_LINEAR) of an HWC float32 image."""
    return resize_bilinear_cv2(torch.from_numpy(np.ascontiguousarray(x)), tuple(size)).numpy()


def corrupt(img: np.ndarray, name: str, severity: int = 1,
            seed: Optional[int] = None) -> np.ndarray:
    """``name`` at ``severity`` (1..5) over an HWC BGR image in [0, 255];
    deterministic for a given ``seed`` (None: 0)."""
    if name not in _PARAMS:
        raise ValueError(f"unknown corruption {name!r} (have {CORRUPTIONS})")
    if not 1 <= severity <= 5:
        raise ValueError(f"severity {severity} is not in 1..5")
    p = _PARAMS[name][severity - 1]
    dtype = img.dtype
    x = img.astype(np.float32) / 255.0
    rs = np.random.RandomState(0 if seed is None else seed)

    if name == "gaussian_noise":
        x = x + rs.normal(0, p, x.shape).astype(np.float32)
    elif name == "shot_noise":
        x = rs.poisson(np.clip(x, 0, 1) * p).astype(np.float32) / p
    elif name == "impulse_noise":
        mask = rs.rand(*x.shape[:2])
        x[mask < p / 2] = 0.0
        x[mask > 1 - p / 2] = 1.0
    elif name == "defocus_blur":
        r = int(p)
        yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
        k = ((yy ** 2 + xx ** 2) <= r ** 2).astype(np.float32)
        k /= k.sum()
        x = filter2d(x, k)
    elif name == "motion_blur":
        k = np.zeros((int(p), int(p)), np.float32)
        k[int(p) // 2, :] = 1.0 / p
        c, s = np.cos(np.deg2rad(25)), np.sin(np.deg2rad(25))
        m = np.float32([[c, -s, p / 2 * (1 - c + s)], [s, c, p / 2 * (1 - s - c)]])
        k = warp_affine(k, m)
        ksum = k.sum()
        if ksum > 0:
            k /= ksum
        x = filter2d(x, k)
    elif name == "zoom_blur":
        h, w = x.shape[:2]
        acc = np.zeros_like(x)
        zooms = np.arange(1.0, p, 0.02)
        for z in zooms:
            zh, zw = int(np.ceil(h / z)), int(np.ceil(w / z))
            y0, x0 = (h - zh) // 2, (w - zw) // 2
            crop = x[y0 : y0 + zh, x0 : x0 + zw]
            acc += resize_linear(crop, (h, w))
        x = acc / len(zooms)
    elif name == "brightness":
        x = x + p
    elif name == "contrast":
        mean = x.mean(axis=(0, 1), keepdims=True)
        x = (x - mean) * p + mean
    elif name == "pixelate":
        h, w = x.shape[:2]
        small = resize_area(x, (max(1, int(h * p)), max(1, int(w * p))))
        x = resize_nearest(small, (h, w))
    elif name == "jpeg_compression":
        u8 = (np.clip(x, 0, 1) * 255).astype(np.uint8)
        x = decode_jpeg(encode_jpeg(u8, int(p))).astype(np.float32) / 255.0

    out = np.clip(x, 0, 1) * 255.0
    return out.astype(dtype) if np.issubdtype(dtype, np.integer) else out


class CorruptImage:
    """Corrupt ``sample['img']`` of a raw sample before any resizing, as the
    JAX package's pipeline step does, with the seed ``seed + img_id`` so
    that images differ and reruns repeat. The image is taken as float32, the
    dtype JAX's ``load_raw`` reads it in, so the result is float32 in
    [0, 255], not truncated to uint8."""

    def __init__(self, name: str, severity: int = 1, seed: Optional[int] = 0):
        if name not in _PARAMS:
            raise ValueError(f"unknown corruption {name!r} (have {CORRUPTIONS})")
        self.name = name
        self.severity = severity
        self.seed = seed

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        sample["img"] = corrupt(np.asarray(sample["img"], np.float32), self.name, self.severity,
                                seed=(self.seed or 0) + int(sample.get("img_id", 0)))
        return sample
