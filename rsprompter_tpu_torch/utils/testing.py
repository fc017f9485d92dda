"""Seeded synthetic batches for tests and tools (``get_flops``, ``benchmark``).

Counterpart of ``rsprompter_tpu/utils/testing.py`` (``demo_batch`` :14),
the analogue of the reference's ``demo_mm_inputs``: random images and padded
ground truth (boxes, labels, masks, validity), in the layout of the port's
``DetInferencer.make_batch`` plus the train step's ground-truth keys, on a
given device. The draws are JAX's, from ``np.random.RandomState(seed)`` in
the same order, so the ground truth is the JAX batch's; JAX's standard
normal images become uint8 BGR as ``clip(round(128 + 64 z), 0, 255)``,
since the port's batch carries uint8 images.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def demo_batch(
    batch_size: int = 2,
    image_size: Tuple[int, int] = (64, 64),
    max_gt: int = 4,
    num_classes: int = 1,
    num_gts: Optional[Sequence[int]] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, torch.Tensor]:
    rs = np.random.RandomState(seed)
    h, w = image_size
    z = rs.randn(batch_size, h, w, 3).astype(np.float32)
    images = np.clip(np.round(128 + 64 * z), 0, 255).astype(np.uint8)
    gt_bboxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_labels = np.zeros((batch_size, max_gt), np.int64)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    gt_masks = np.zeros((batch_size, max_gt, h, w), np.uint8)
    for b in range(batch_size):
        n = num_gts[b] if num_gts is not None else rs.randint(1, max_gt + 1)
        for g in range(min(n, max_gt)):
            cx, cy = rs.rand(2) * [w * 0.6, h * 0.6] + [w * 0.2, h * 0.2]
            bw, bh = rs.rand(2) * [w * 0.3, h * 0.3] + 4
            x1, y1 = max(cx - bw / 2, 0), max(cy - bh / 2, 0)
            x2, y2 = min(cx + bw / 2, w), min(cy + bh / 2, h)
            gt_bboxes[b, g] = [x1, y1, x2, y2]
            gt_labels[b, g] = rs.randint(num_classes)
            gt_valid[b, g] = True
            gt_masks[b, g, int(y1) : int(y2), int(x1) : int(x2)] = 1
    arrays = {
        "images": images,
        "img_shape": np.array([[h, w]] * batch_size, np.int32),
        "ori_shape": np.array([[h, w]] * batch_size, np.int32),
        "scale_factor": np.ones((batch_size, 2), np.float32),
        "gt_bboxes": gt_bboxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
        "gt_masks": gt_masks,
    }
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
