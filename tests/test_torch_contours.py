"""``data/contours.py`` against OpenCV on seeded masks.

``connected_components_with_stats`` equals
``cv2.connectedComponentsWithStats(mask, connectivity=8)`` (count, labels in
OpenCV's block order, stats, centroids); ``find_external_contours`` equals
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]`` point for
point and in order; ``component_contour`` equals ``findContours`` on each
component alone. Masks: random at several densities, rectangles with holes,
corner-touching pairs and diagonal lines, one-pixel parts and spurs,
components on the edge, nested rings, odd heights and widths, and the
synthetic WHU building masks.
"""

import cv2
import numpy as np
import pytest

from rsprompter_tpu_torch.data.contours import (component_contour,
                                                connected_components_with_stats,
                                                find_external_contours)
from rsprompter_tpu_torch.utils.synthetic import whu_mask


def _random(rng):
    h, w = rng.integers(1, 140, 2)
    return (rng.random((h, w)) < rng.uniform(0.02, 0.6)).astype(np.uint8)


def _shapes(rng):
    h, w = rng.integers(7, 95, 2) | 1  # odd sizes
    m = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 8))):
        y, x = rng.integers(0, h), rng.integers(0, w)
        m[y:y + rng.integers(1, 25), x:x + rng.integers(1, 25)] = 1
        if rng.random() < 0.5:  # a hole
            m[y + 1:y + rng.integers(2, 12), x + 1:x + rng.integers(2, 12)] = 0
    for _ in range(int(rng.integers(0, 4))):  # diagonals and one-pixel lines
        y, x, n = rng.integers(0, h), rng.integers(0, w), rng.integers(1, 15)
        d = rng.choice([-1, 1])
        for k in range(n):
            if 0 <= y + k < h and 0 <= x + d * k < w:
                m[y + k, x + d * k] = 1
    return m * rng.integers(1, 256)  # any non-zero value is foreground


def _corners_edges(rng):
    h, w = rng.integers(10, 60, 2)
    m = np.zeros((h, w), np.uint8)
    s = int(rng.integers(1, 5))
    y, x = rng.integers(0, max(1, h - 2 * s)), rng.integers(0, max(1, w - 2 * s))
    m[y:y + s, x:x + s] = 1
    m[y + s:y + 2 * s, x + s:x + 2 * s] = 1  # touching at a corner only
    m[0, :] = rng.random(w) < 0.5  # the edges
    m[:, -1] = rng.random(h) < 0.5
    m[rng.integers(0, h), :rng.integers(1, w)] = 1  # a one-pixel-wide spur
    return m


def _nested(rng):
    n = int(rng.integers(15, 40))
    m = np.zeros((n, n), np.uint8)
    for k in range(0, n // 2, 2):
        m[k:n - k, k:n - k] = 1 - m[k, k] if k else 1
    m[n // 2, n // 2] = 1
    return m


KINDS = {"random": _random, "shapes": _shapes, "corners_edges": _corners_edges,
         "nested": _nested}


def _check(m):
    ref = cv2.connectedComponentsWithStats((m > 0).astype(np.uint8), connectivity=8)
    cc = connected_components_with_stats(m)
    n, labels, stats, centroids = cc
    assert n == ref[0]
    np.testing.assert_array_equal(labels, ref[1])
    np.testing.assert_array_equal(stats, ref[2])
    np.testing.assert_array_equal(centroids, ref[3])  # NaN where OpenCV's is
    assert labels.dtype == np.int32 and stats.dtype == np.int32
    contours, _ = cv2.findContours((m > 0).astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    got = find_external_contours(m)
    assert len(got) == len(contours)
    for a, b in zip(got, contours):
        np.testing.assert_array_equal(a, b)
    for label in range(1, n):
        one, _ = cv2.findContours((labels == label).astype(np.uint8), cv2.RETR_EXTERNAL,
                                  cv2.CHAIN_APPROX_SIMPLE)
        assert len(one) == 1
        np.testing.assert_array_equal(component_contour(cc, label), one[0])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_equal_to_opencv_on_seeded_masks(kind):
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    for _ in range(60):
        _check(KINDS[kind](rng))


def test_equal_to_opencv_on_whu_masks():
    rng = np.random.default_rng(5)
    for _ in range(2):
        _check(whu_mask(rng, 256))


def test_documented_cases():
    m = np.zeros((4, 8), np.uint8)
    m[0, 6] = m[1, 0] = 1  # OpenCV labels (1, 0) first: its 2 x 2 block comes first
    assert connected_components_with_stats(m).labels[1, 0] == 1
    m = np.zeros((9, 9), np.uint8)
    m[2:5, 2:6] = 1
    assert find_external_contours(m)[0].reshape(-1, 2).tolist() == [[2, 2], [2, 4], [5, 4],
                                                                     [5, 2]]
    m = np.zeros((8, 8), np.uint8)
    m[0:4, 0:5] = 1
    m[1:3, 1:3] = 0  # a hole: it emits nothing
    assert [c.reshape(-1, 2).tolist() for c in find_external_contours(m)] == \
        [[[0, 0], [0, 3], [4, 3], [4, 0]]]
    m = np.zeros((6, 6), np.uint8)
    m[1:5, 2] = 1  # four pixels one wide: two points, which whu2coco drops
    assert len(find_external_contours(m)[0]) == 2
    full = np.ones((3, 5), np.uint8)  # no background: OpenCV's values for label 0
    n, _, stats, centroids = connected_components_with_stats(full)
    assert n == 2 and stats[0].tolist() == [-1, 2147483647, 0, 0, 0]
    assert np.isnan(centroids[0]).all()
