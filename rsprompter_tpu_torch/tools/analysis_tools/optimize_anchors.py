"""k-means of RPN anchor shapes over a dataset's ground-truth boxes.

    python -m rsprompter_tpu_torch.tools.analysis_tools.optimize_anchors CONFIG \\
        [--k 9] [--iters 100] [--max-images 500] [--seed 0]

The port's counterpart of the JAX package's
``tools/analysis_tools/optimize_anchors.py`` (the reference's YOLO-style
k-means with an IoU objective): the train set's GT (w, h), scaled by the
test pipeline's keep-ratio resize into the model's input frame, clustered
into ``k`` anchors (assignment by the largest IoU, update by the median).
Prints the anchors by area and their mean best IoU over the boxes.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="k-means anchor optimisation")
    p.add_argument("config")
    p.add_argument("--k", type=int, default=9, help="number of anchors")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--max-images", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def wh_iou(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """(N, K) IoU of boxes and anchors sharing one centre."""
    inter = (np.minimum(wh[:, None, 0], anchors[None, :, 0])
             * np.minimum(wh[:, None, 1], anchors[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def kmeans_anchors(wh: np.ndarray, k: int, iters: int = 100,
                   seed: int = 0) -> Tuple[np.ndarray, float]:
    """-> (anchors (k, 2) by area, mean best IoU)."""
    rs = np.random.RandomState(seed)
    anchors = wh[rs.choice(len(wh), k, replace=len(wh) < k)].astype(np.float64)
    assign = np.full(len(wh), -1)
    for _ in range(iters):
        new_assign = wh_iou(wh, anchors).argmax(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            sel = wh[assign == c]
            if len(sel):
                anchors[c] = np.median(sel, axis=0)
    mean_iou = float(wh_iou(wh, anchors).max(1).mean())
    return anchors[np.argsort(anchors[:, 0] * anchors[:, 1])], mean_iou


def collect_wh(cfg, max_images: int) -> np.ndarray:
    """GT (w, h) in the model's input frame, from the annotations' sizes
    (no image is decoded)."""
    crop = tuple(cfg.get("crop_size", (1024, 1024)))
    ds = DATASETS.build(dict(cfg["train_dataloader"]["dataset"]))
    whs = []
    for info in ds.data_list[:max_images]:
        ih, iw = info.get("height"), info.get("width")
        boxes = np.asarray([a["bbox"] for a in info["anns"] if not a.get("iscrowd", 0)],
                           np.float64).reshape(-1, 4)  # xywh
        if ih is None or not len(boxes):
            continue
        whs.append(boxes[:, 2:] * min(crop[0] / ih, crop[1] / iw))
    if not whs:
        raise SystemExit("no GT boxes found (dataset empty or missing sizes)")
    wh = np.concatenate(whs)
    return wh[(wh > 1).all(1)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    wh = collect_wh(cfg, args.max_images)
    anchors, mean_iou = kmeans_anchors(wh, args.k, args.iters, args.seed)
    print(f"{len(wh)} GT boxes, k={args.k}")
    print("anchors (w, h) sorted by area:")
    for w, h in anchors:
        print(f"  ({w:.1f}, {h:.1f})")
    print(f"mean best-IoU coverage: {mean_iou:.4f}")
    return dict(anchors=anchors, mean_iou=mean_iou, boxes=len(wh))


if __name__ == "__main__":
    main()
