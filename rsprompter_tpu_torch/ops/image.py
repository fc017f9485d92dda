"""OpenCV's INTER_LINEAR image resize, in float torch ops on the device.

The JAX package's pipelines read every image as float32
(``apis/inferencer.py:_load_image``, ``data/coco.py:load_raw``), resize it
with ``cv2.resize(..., INTER_LINEAR)`` (``data/transforms.py:_resize_img``)
and round it back to uint8 (``PackDetInputs``). The card's machine has no
OpenCV, so the port rebuilds OpenCV's float scheme:

- per output column / row: ``f = (d + 0.5) * scale - 0.5`` in double,
  ``s = floor(f)``, weights ``1 - float32(f - s)`` and ``float32(f - s)``;
  a source index past either edge clamps to the edge with weights (1, 0);
- one horizontal and one vertical two-tap pass in float32;
- an exact halving in both axes is OpenCV's 2x2 area average.

Held against ``cv2.resize`` in ``tests/test_torch_resize.py``: the float
results agree to a few ulps (OpenCV's vector code orders its sums
differently), and after rounding a few pixels in 10^6 differ by one level.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _linear_coefs(n_in: int, n_out: int):
    """(src0, src1, w0, w1): int64 indices and float32 weights, length n_out."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    low = s < 0
    frac[low], s[low] = 0, 0
    high = s >= n_in - 1
    frac[high], s[high] = 0, n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1) - frac, frac


def resize_bilinear_cv2(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img.astype(float32), (w, h), interpolation=INTER_LINEAR)``
    for an (H, W, C) tensor; ``size`` is (h, w). float32, on img's device."""
    x = img.float()
    h, w = img.shape[:2]
    nh, nw = size
    if (nh, nw) == (h, w):
        return x
    if h == 2 * nh and w == 2 * nw:
        return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * 0.25
    dev = img.device
    xs0, xs1, xa0, xa1 = (torch.as_tensor(a, device=dev) for a in _linear_coefs(w, nw))
    ys0, ys1, ya0, ya1 = (torch.as_tensor(a, device=dev) for a in _linear_coefs(h, nh))
    d = x[:, xs0] * xa0[None, :, None] + x[:, xs1] * xa1[None, :, None]
    return d[ys0] * ya0[:, None, None] + d[ys1] * ya1[:, None, None]
