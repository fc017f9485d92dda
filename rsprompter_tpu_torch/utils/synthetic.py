"""Seeded synthetic training batches (numpy), for the train step's checks.

The NWPU images and the SAM weights are not in the repository, so the train
step is driven on images made from a seed: smooth random fields plus noise
(uint8 BGR, as the data pipeline ships them), a few ground-truth boxes per
image, each with an elliptical mask inside its box, padded to ``max_gt`` with
``gt_valid`` false.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
