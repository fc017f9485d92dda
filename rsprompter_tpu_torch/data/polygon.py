"""``cv2.fillPoly(mask, polygons, 1)`` rebuilt without OpenCV.

The JAX package rasterises COCO polygons with OpenCV (``data/coco.py:21``);
the card's machine has none. This is OpenCV's own algorithm for integer
vertices with ``LINE_8`` and no sub-pixel shift (``imgproc/src/drawing.cpp``:
``fillPoly`` -> ``CollectPolyEdges`` -> ``FillEdgeCollection``): each edge is
drawn as an 8-connected Bresenham line (clipped to the image first, as
``LineIterator`` clips it), and the polygons' non-horizontal edges, in 16.16
fixed point, feed one even-odd scanline fill over all of them together (a
span from the ceiling of its left x to the floor of its right x). Pixel for
pixel the same as OpenCV 5.0's ``fillPoly``, vertices outside the image
included (``tests/test_torch_data.py`` holds it there).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
DELTA = XY_ONE - 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a w x h image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected ``Line`` (``LineIterator``, left to right)."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # along the major axis one pixel a step; along the minor one where err < 0
    k = np.arange(dx + 1, dtype=np.int64)
    minor = _bresenham_minor(dx, dy, dx + 1)
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    mask[ys, xs] = 1


def _bresenham_minor(dx: int, dy: int, count: int) -> np.ndarray:
    """The minor-axis offset at each step of OpenCV's 8-connected iterator
    (err = dx - 2 dy; each step err -= 2 dy, plus 2 dx and a minor step
    where err was negative)."""
    out = np.empty(count, np.int64)
    err, s = dx - 2 * dy, 0
    for i in range(count):
        out[i] = s
        if err < 0:
            err += 2 * dx - 2 * dy
            s += 1
        else:
            err -= 2 * dy
    return out


def _collect_edges(mask: np.ndarray, pts: np.ndarray, edges: List[list]) -> None:
    """``CollectPolyEdges`` for one polygon of integer vertices."""
    h, w = mask.shape
    n = len(pts)
    x0, y0 = int(pts[n - 1][0]), int(pts[n - 1][1])
    for i in range(n):
        x1, y1 = int(pts[i][0]), int(pts[i][1])
        line8(mask, x0, y0, x1, y1)
        # the edge in fixed point; where the line leaves the image, OpenCV
        # takes the x of its clipped ends (the clip's result unchecked), and
        # their y where they differ, and extends that line to the vertices' y
        cx0, cy0, cx1, cy1 = x0 << XY_SHIFT, y0, x1 << XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, tx0, ty0, tx1, ty1 = clip_line(w, h, x0, y0, x1, y1)
            cx0, cx1 = tx0 << XY_SHIFT, tx1 << XY_SHIFT
            if ty0 != ty1:
                cy0, cy1 = ty0, ty1
        if y0 != y1:
            dxe = _tdiv(cx1 - cx0, cy1 - cy0)
            if y0 < y1:
                edges.append([y0, y1, cx0 + (y0 - cy0) * dxe, dxe])
            else:
                edges.append([y1, y0, cx1 + (y1 - cy1) * dxe, dxe])
        x0, y0 = x1, y1


def _fill_edges(mask: np.ndarray, edges: List[list]) -> None:
    """``FillEdgeCollection``: an even-odd scanline fill over every edge."""
    h, w = mask.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active: List[list] = []
    i, total = 0, len(edges)
    for y in range(edges[0][0], y_max):
        # drop the edges that end here, then insert those that start here,
        # merged by x into the active list (kept sorted by x)
        old = [e for e in active if e[1] != y]
        active, j = [], 0
        while i < total and edges[i][0] == y:
            e = edges[i]
            while j < len(old) and old[j][2] < e[2]:
                active.append(old[j])
                j += 1
            active.append(e)
            i += 1
        active += old[j:]
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                if a[2] > b[2]:
                    x1, x2 = (b[2] + DELTA) >> XY_SHIFT, a[2] >> XY_SHIFT
                else:
                    x1, x2 = (a[2] + DELTA) >> XY_SHIFT, b[2] >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])  # stable, as OpenCV's bubble sort


def fill_poly(mask: np.ndarray, polygons: Sequence[np.ndarray]) -> np.ndarray:
    """``cv2.fillPoly(mask, polygons, 1)`` on a 2-D uint8 mask, in place;
    each polygon an (N, 2) integer array of x, y vertices."""
    edges: List[list] = []
    for pts in polygons:
        _collect_edges(mask, np.asarray(pts, np.int64).reshape(-1, 2), edges)
    _fill_edges(mask, edges)
    return mask
