"""Sliced inference over large scenes (satellite imagery).

The port's copy of ``rsprompter_tpu/utils/large_image.py`` (``slice_offsets``
:18, ``nms_np`` :37, ``merge_patch_predictions`` :59, ``paste_scene_masks``
:123), numpy only: the reference's ``demo/large_image_demo.py`` pipeline
(sahi ``slice_image`` -> per-patch inference -> ``shift_predictions`` ->
``merge_results_by_nms``, ``mmdet/utils/large_image.py``) with every patch
of the same size, so the scene runs as a few fixed-shape batches.
``tests/test_torch_large_image.py`` holds the four functions equal to
JAX's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def slice_offsets(
    h: int, w: int, patch: int, overlap: float = 0.25
) -> List[Tuple[int, int]]:
    """Top-left corners of ``patch``-sized tiles covering (h, w) with the
    given overlap ratio; the final row/col snaps inside the image so every
    tile is full-sized (static shapes)."""
    if not 0 <= overlap < 1:
        raise ValueError(f"overlap {overlap} is not in [0, 1)")
    stride = max(1, int(patch * (1 - overlap)))

    def starts(total):
        if total <= patch:
            return [0]
        s = list(range(0, total - patch, stride))
        s.append(total - patch)  # snap the last tile inside
        return sorted(set(s))

    return [(x, y) for y in starts(h) for x in starts(w)]


def nms_np(
    boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5
) -> np.ndarray:
    """Greedy NMS (host numpy) -> kept indices, score-descending."""
    order = np.argsort(-scores, kind="mergesort")
    boxes = boxes[order]
    keep = []
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    sup = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if sup[i]:
            continue
        keep.append(order[i])
        lt = np.maximum(boxes[i, :2], boxes[i + 1 :, :2])
        rb = np.minimum(boxes[i, 2:], boxes[i + 1 :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.maximum(area[i] + area[i + 1 :] - inter, 1e-9)
        sup[i + 1 :] |= iou > iou_thr
    return np.asarray(keep, np.int64)


def merge_patch_predictions(
    preds: Sequence[Dict],
    offsets: Sequence[Tuple[int, int]],
    scene_hw: Tuple[int, int],
    iou_thr: float = 0.5,
    max_dets: int = 300,
) -> Dict:
    """Shift per-patch predictions to scene coordinates and merge duplicates
    from overlapping tiles with class-wise NMS.

    preds: per-patch dicts {bboxes, scores, labels, masks? (N, ph, pw)};
    returns one scene-level dict. Masks come back as ``(patch_mask, (x0,
    y0))`` pairs — per-instance FULL-SCENE canvases would be
    O(dets * H * W) host memory (~20 GB at 300 dets on an 8192^2 scene);
    use :func:`paste_scene_masks` to materialize them one at a time.
    """
    h, w = scene_hw
    boxes, scores, labels, masks, patch_of = [], [], [], [], []
    for pi, (pred, (x0, y0)) in enumerate(zip(preds, offsets)):
        b = np.asarray(pred["bboxes"], np.float32).reshape(-1, 4)
        if not len(b):
            continue
        b = b + np.array([x0, y0, x0, y0], np.float32)
        b[:, 0::2] = b[:, 0::2].clip(0, w)
        b[:, 1::2] = b[:, 1::2].clip(0, h)
        boxes.append(b)
        scores.append(np.asarray(pred["scores"], np.float32))
        labels.append(np.asarray(pred["labels"], np.int64))
        patch_of.extend([pi] * len(b))
        pm = pred.get("masks")
        # keep masks index-aligned with detections even when only some
        # patches carry masks
        masks.extend(
            [m.astype(bool) for m in np.asarray(pm)] if pm is not None
            else [None] * len(b)
        )
    if not boxes:
        return dict(bboxes=np.zeros((0, 4)), scores=np.zeros(0),
                    labels=np.zeros(0, np.int64), masks=None)
    boxes = np.concatenate(boxes)
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)
    patch_of = np.asarray(patch_of)

    keep_all = []
    for c in np.unique(labels):
        sel = np.flatnonzero(labels == c)
        kept = nms_np(boxes[sel], scores[sel], iou_thr)
        keep_all.extend(sel[kept])
    keep_all = np.asarray(sorted(keep_all, key=lambda i: -scores[i]))[:max_dets]

    out = dict(
        bboxes=boxes[keep_all], scores=scores[keep_all], labels=labels[keep_all]
    )
    if any(masks[i] is not None for i in keep_all):
        out["masks"] = [
            (masks[i], offsets[patch_of[i]]) if masks[i] is not None else None
            for i in keep_all
        ]
    else:
        out["masks"] = None
    return out


def paste_scene_masks(mask_pairs, scene_hw: Tuple[int, int]):
    """Yield full-scene boolean masks one at a time from merge output's
    ``(patch_mask, (x0, y0))`` pairs (O(H*W) peak, not O(N*H*W))."""
    h, w = scene_hw
    for pair in mask_pairs:
        if pair is None:
            yield np.zeros((h, w), bool)
            continue
        m, (x0, y0) = pair
        canvas = np.zeros((h, w), bool)
        canvas[y0 : y0 + m.shape[0], x0 : x0 + m.shape[1]] = m
        yield canvas
