"""Connected components and outer contours of binary masks, as OpenCV gives
them, for the WHU converter (``tools/rsprompter/whu2coco.py``).

- :func:`connected_components_with_stats` is
  ``cv2.connectedComponentsWithStats(mask, connectivity=8)``: the count,
  int32 labels, int32 stats ``[x, y, w, h, area]`` and float64 centroids,
  label 0 the background, the other labels in OpenCV's order (each
  component's first 2 x 2 block in raster order of blocks).
- :func:`find_external_contours` is ``cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)[0]``: one (N, 1, 2) int32 array of (x, y) points a
  component that lies inside no other's hole, in OpenCV's order (the last
  found first); holes emit nothing.
- :func:`component_contour` traces one component of
  :func:`connected_components_with_stats` from its first pixel: the
  contour ``find_external_contours(labels == i)`` gives, without a
  full-size mask a component.

The per-pixel loops are C++ (``rsprompter_tpu_torch/native/contours.cpp``),
built with ``g++`` at first use into ``build/native/`` and bound with
ctypes.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from rsprompter_tpu_torch.utils import native

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "contours.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
_p = ctypes.c_void_p
_SIGNATURES = {
    "cc_label8": (ctypes.c_int64, [_p, ctypes.c_int, ctypes.c_int, _p, _p, _p, _p,
                                   ctypes.c_int64]),
    "cc_trace_outer": (ctypes.c_int64, [_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, _p, ctypes.c_int64]),
}
_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    with _lock:
        if SOURCE not in _libs:
            _libs[SOURCE] = native.load_library(SOURCE, BUILD_DIR, _SIGNATURES)
        return _libs[SOURCE]


class Components:
    """:func:`connected_components_with_stats`'s result, with what
    :func:`component_contour` needs: the binary mask and each label's first
    pixel in raster order."""

    def __init__(self, mask, n, labels, stats, centroids, first):
        self.mask, self.n, self.labels = mask, n, labels
        self.stats, self.centroids, self.first = stats, centroids, first

    def __iter__(self):  # n, labels, stats, centroids: OpenCV's tuple
        return iter((self.n, self.labels, self.stats, self.centroids))


def _binary(mask: np.ndarray) -> np.ndarray:
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"a mask is (H, W), not {mask.shape}")
    return np.ascontiguousarray(mask != 0, dtype=np.uint8)


def connected_components_with_stats(mask: np.ndarray, connectivity: int = 8) -> Components:
    """``cv2.connectedComponentsWithStats(mask, connectivity=8)``; unpacks
    as its ``(n, labels, stats, centroids)``."""
    if connectivity != 8:
        raise ValueError(f"connectivity {connectivity}: only 8 is implemented")
    m = _binary(mask)
    h, w = m.shape
    cap = (h + 1) // 2 * ((w + 1) // 2) + 1
    labels = np.empty((h, w), np.int32)
    stats = np.empty((cap, 5), np.int32)
    sums = np.empty((cap, 2), np.int64)
    first = np.empty(cap, np.int64)
    n = load_library().cc_label8(m.ctypes.data, h, w, labels.ctypes.data, stats.ctypes.data,
                                 sums.ctypes.data, first.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("cc_label8: more labels than 2 x 2 blocks")
    area = stats[:n, 4:5].astype(np.float64)
    with np.errstate(invalid="ignore"):
        centroids = sums[:n] / area  # 0 / 0: NaN, as OpenCV's empty background
    return Components(m, int(n), labels, stats[:n].copy(), centroids, first[:n].copy())


def _trace(m: np.ndarray, x: int, y: int) -> np.ndarray:
    lib = load_library()
    h, w = m.shape
    cap = 256
    while True:
        pts = np.empty((cap, 2), np.int32)
        n = lib.cc_trace_outer(m.ctypes.data, h, w, x, y, pts.ctypes.data, cap)
        if n <= cap:
            return pts[:n].reshape(n, 1, 2)
        cap = int(n)


def component_contour(cc: Components, label: int) -> np.ndarray:
    """The outer contour, (N, 1, 2) int32 (x, y), of component ``label``:
    ``cv2.findContours(labels == label, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)[0][0]``. No other component touches it, so it is
    traced on the whole mask."""
    y, x = divmod(int(cc.first[label]), cc.mask.shape[1])
    return _trace(cc.mask, x, y)


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``."""
    cc = connected_components_with_stats(mask)
    if cc.n <= 1:
        return []
    # a component is external where the background left of its first pixel
    # reaches the image's frame through 4-connected background
    outside = _frame_background(cc.mask)
    h, w = cc.mask.shape
    starts: List[Tuple[int, int]] = []
    for label in range(1, cc.n):
        y, x = divmod(int(cc.first[label]), w)
        if x == 0 or outside[y, x - 1]:
            starts.append((y, x))
    starts.sort()  # found in raster order; OpenCV lists the last found first
    return [_trace(cc.mask, x, y) for y, x in reversed(starts)]


def _frame_background(m: np.ndarray) -> np.ndarray:
    """Background pixels 4-connected to the image's frame (a zero border
    around the image): a flood fill from the frame, one step a pass."""
    pad = np.pad(m == 0, 1, constant_values=True)
    seen = np.zeros_like(pad)
    seen[0, :] = seen[-1, :] = seen[:, 0] = seen[:, -1] = True
    frontier = seen.copy()
    while frontier.any():
        grow = np.zeros_like(pad)
        grow[1:] |= frontier[:-1]
        grow[:-1] |= frontier[1:]
        grow[:, 1:] |= frontier[:, :-1]
        grow[:, :-1] |= frontier[:, 1:]
        frontier = grow & pad & ~seen
        seen |= frontier
    return seen[1:-1, 1:-1]
