"""Seeded synthetic data (numpy): training batches and a COCO test set.

The NWPU images and the SAM weights are not in the repository, so the train
step is driven on images made from a seed: smooth random fields plus noise
(uint8 BGR, as the data pipeline ships them), a few ground-truth boxes per
image, each with an elliptical mask inside its box, padded to ``max_gt`` with
``gt_valid`` false. :func:`synthetic_coco` writes a small COCO set (images
and annotations) for the evaluation path.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def synthetic_batch(batch_size: int, image_size: Tuple[int, int], num_classes: int,
                    max_gt: int = 8, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    h, w = image_size
    cell = max(min(h, w) // 16, 1)
    coarse = rng.uniform(0, 255, (batch_size, h // cell + 1, w // cell + 1, 3))
    field = np.kron(coarse, np.ones((1, cell, cell, 1)))[:, :h, :w]
    images = np.clip(field + rng.normal(0, 12, field.shape), 0, 255).astype(np.uint8)
    gt_bboxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_labels = np.zeros((batch_size, max_gt), np.int64)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    gt_masks = np.zeros((batch_size, max_gt, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    for b in range(batch_size):
        for g in range(int(rng.integers(1, max_gt))):
            bw, bh = rng.uniform(0.08, 0.4, 2) * (w, h)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            gt_bboxes[b, g] = (x1, y1, x1 + bw, y1 + bh)
            gt_labels[b, g] = rng.integers(num_classes)
            gt_valid[b, g] = True
            cx, cy = x1 + bw / 2, y1 + bh / 2
            inside = ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2 <= 1.0
            gt_masks[b, g] = inside
    return {
        "images": images,
        "img_shape": np.array([[h, w]] * batch_size, np.int32),
        "gt_bboxes": gt_bboxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
        "gt_masks": gt_masks,
    }


SIZE_RADII = ((5.0, 14.0), (30.0, 55.0), (70.0, 200.0))  # pixels


def synthetic_coco(root: str, classes: Sequence[str], sizes: Sequence[Tuple[int, int]],
                   write_image: Callable[[str, np.ndarray], object], seed: int = 0) -> str:
    """Write a seeded COCO instance-segmentation set under ``root``: one
    uint8 BGR image a size in ``imgs/`` (``write_image(path, img)`` writes
    it as PNG), and ``ann.json`` with categories 1..C named ``classes``. Each image has
    two to five objects: star-shaped polygons with sub-pixel vertices, every
    third one an uncompressed RLE of an ellipse instead; the middle image
    has none, and the first one also holds a crowd region (RLE). Object
    radii cycle through ``SIZE_RADII`` (capped at 0.3 of the image's short
    side), so large images hold GT in all three COCO area ranges. Returns
    ``root``."""
    from rsprompter_tpu_torch.evaluation.rle import encode_masks_plain

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        cell = max(min(h, w) // 16, 1)
        coarse = rng.uniform(0, 255, (h // cell + 1, w // cell + 1, 3))
        field = np.kron(coarse, np.ones((cell, cell, 1)))[:h, :w]
        img = np.clip(field + rng.normal(0, 12, field.shape), 0, 255).astype(np.uint8)
        name = f"{i:03d}.png"
        write_image(os.path.join(root, "imgs", name), img)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        n_obj = 0 if i == len(sizes) // 2 else int(rng.integers(2, 6))
        for k in range(n_obj + (i == 0)):
            crowd = i == 0 and k == n_obj
            # small, medium and large objects in turn (COCO's area ranges)
            r = min(rng.uniform(*SIZE_RADII[k % 3]), 0.3 * min(h, w))
            cx, cy = rng.uniform(r, w - r), rng.uniform(r, h - r)
            ann = dict(id=len(anns) + 1, image_id=i + 1, iscrowd=int(crowd),
                       category_id=int(rng.integers(len(classes))) + 1)
            if crowd or k % 3 == 2:
                yy, xx = np.mgrid[0:h, 0:w]
                m = ((xx - cx) / r) ** 2 + ((yy - cy) / (0.6 * r)) ** 2 <= 1.0
                ys, xs = np.nonzero(m)
                ann.update(segmentation=dict(size=[h, w], counts=encode_masks_plain(
                    m[None])[0].counts.tolist()), area=float(m.sum()),
                    bbox=[float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                          float(ys.max() - ys.min() + 1)])
            else:
                n = int(rng.integers(5, 9))
                ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                rad = r * rng.uniform(0.5, 1.0, n)
                px = np.clip(cx + rad * np.cos(ang), 0, w - 1)
                py = np.clip(cy + rad * np.sin(ang), 0, h - 1)
                area = 0.5 * abs(np.dot(px, np.roll(py, 1)) - np.dot(py, np.roll(px, 1)))
                ann.update(segmentation=[np.stack([px, py], 1).reshape(-1).round(2).tolist()],
                           area=float(area), bbox=[float(px.min()), float(py.min()),
                                                   float(px.max() - px.min()),
                                                   float(py.max() - py.min())])
            anns.append(ann)
    cats = [dict(id=c + 1, name=n) for c, n in enumerate(classes)]
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return root


WHU_SPLITS = {"train": 6, "test": 4}  # tiles a split


def _convex(rng, cx: float, cy: float, r: float, n: int, yy, xx) -> np.ndarray:
    """A convex polygon's pixels: the points inside every edge's half-plane."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    px, py = cx + r * np.cos(ang), cy + r * np.sin(ang)
    inside = np.ones(yy.shape, bool)
    for i in range(n):
        x1, y1, x2, y2 = px[i], py[i], px[(i + 1) % n], py[(i + 1) % n]
        inside &= (x2 - x1) * (yy - y1) - (y2 - y1) * (xx - x1) >= 0
    return inside


def whu_mask(rng, size: int) -> np.ndarray:
    """A seeded (size, size) uint8 building mask (0 / 255): rectangles, some
    with a courtyard; convex polygons; pairs touching at a corner only; a
    rectangle on each edge; one-pixel-wide lines (straight, diagonal, and a
    spur out of a rectangle); components of 1-3 pixels and a 4-pixel line,
    which the converter drops."""
    m = np.zeros((size, size), bool)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(int(rng.integers(6, 10))):
        h, w = rng.integers(10, 60, 2)
        y, x = rng.integers(8, size - 70, 2)
        m[y:y + h, x:x + w] = True
        if rng.random() < 0.35 and h > 12 and w > 12:  # a courtyard: a hole
            m[y + 4:y + h - 4, x + 4:x + w - 4] = False
    for _ in range(int(rng.integers(2, 5))):
        m |= _convex(rng, *rng.uniform(40, size - 40, 2), rng.uniform(8, 30),
                     int(rng.integers(3, 8)), yy, xx)
    for _ in range(2):  # touching at one corner: one 8-connected component
        s = int(rng.integers(5, 15))
        y, x = rng.integers(20, size - 2 * s - 20, 2)
        m[y:y + s, x:x + s] = True
        m[y + s:y + 2 * s, x + s:x + 2 * s] = True
    e = int(rng.integers(30, size - 80))
    m[0:int(rng.integers(5, 20)), e:e + 40] = True  # on each edge
    m[e:e + 30, 0:int(rng.integers(3, 12))] = True
    m[size - 7:, e // 2:e // 2 + 25] = True
    m[e // 3:e // 3 + 18, size - 1] = True
    y, x = rng.integers(20, size - 60, 2)
    m[y, x:x + 30] = True  # one pixel wide
    for k in range(25):
        m[(y + 10 + k) % size, (x + k) % size] = True  # diagonal
    y, x = rng.integers(20, size - 80, 2)
    m[y:y + 20, x:x + 20] = True
    m[y + 10, x + 20:x + 35] = True  # a spur walked out and back
    for k in range(3):
        y, x = rng.integers(4, size - 8, 2)
        m[y:y + 1, x:x + k + 1] = True  # 1-3 pixels
    y, x = rng.integers(4, size - 8, 2)
    m[y:y + 4, x] = True  # 4 pixels, one wide: a 2-point contour
    return m.astype(np.uint8) * 255


def synthetic_whu(root: str, splits: Optional[Dict[str, int]] = None, size: int = 512,
                  seed: int = 0) -> str:
    """Write a seeded WHU-building-style tree under ``root``:
    ``imgs/{split}/image/tile_NNN.tif`` (size x size RGB) and
    ``imgs/{split}/label/tile_NNN.tif`` (8-bit grey building masks,
    :func:`whu_mask`), uncompressed and PackBits in turn; the train split
    also holds one image without a mask, which the converter skips. The
    roofs are the mask's pixels in a colour a tile over a smooth ground
    field. Returns ``root``."""
    from rsprompter_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    for split, n in (splits or WHU_SPLITS).items():
        for sub in ("image", "label"):
            os.makedirs(os.path.join(root, "imgs", split, sub), exist_ok=True)
        for i in range(n + (split == "train")):
            mask = whu_mask(rng, size)
            coarse = rng.uniform(60, 190, (size // 32 + 1, size // 32 + 1, 3))
            img = np.kron(coarse, np.ones((32, 32, 1)))[:size, :size]
            img[mask > 0] = rng.uniform(20, 235, 3)
            img = np.clip(img + rng.integers(-3, 4, img.shape), 0, 255).astype(np.uint8)
            name = f"tile_{i:03d}.tif"
            image_comp, mask_comp = (tiff.NONE, tiff.PACKBITS) if i % 2 else \
                (tiff.PACKBITS, tiff.NONE)
            with open(os.path.join(root, "imgs", split, "image", name), "wb") as f:
                f.write(tiff.encode_tiff(img[:, :, ::-1], tiff.RGB, compression=image_comp,
                                         rows_per_strip=64))
            if i == n:
                continue  # the image without a mask
            with open(os.path.join(root, "imgs", split, "label", name), "wb") as f:
                f.write(tiff.encode_tiff(mask, tiff.MIN_IS_BLACK, compression=mask_comp,
                                         rows_per_strip=128))
    return root
