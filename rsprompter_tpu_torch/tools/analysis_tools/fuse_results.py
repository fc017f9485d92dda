"""Fuse the detections of several models by Weighted Boxes Fusion and
evaluate again.

    python -m rsprompter_tpu_torch.tools.analysis_tools.fuse_results A.json B.json \\
        [C.json ...] [--iou-thr 0.55] [--out fused.json]

The port's copy of the JAX package's ``tools/analysis_tools/fuse_results.py``
(the reference's WBF ensemble), which imports no JAX but its sibling
``eval_metric``: here the port's. It reads N ``tools.test --out`` dumps of
one evaluation split in one order. Boxes of one class whose IoU exceeds
``--iou-thr`` cluster; each cluster gives one box at the score-weighted mean
position, its score the cluster's mean scaled by the share of models that
voted for it. Masks are not fused: the fused dump evaluates bbox only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.tools.analysis_tools.eval_metric import evaluate_dump


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="weighted boxes fusion")
    p.add_argument("results", nargs="+", help="two or more tools.test dumps")
    p.add_argument("--iou-thr", type=float, default=0.55)
    p.add_argument("--out", default=None, help="write the fused dump here")
    return p.parse_args(argv)


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


def weighted_boxes_fusion(
    boxes_list, scores_list, labels_list, iou_thr: float = 0.55,
    num_models: int = None,
):
    """Standard WBF (Solovyev et al.): greedy clustering by IoU within a
    class; fused box = score-weighted average of the cluster, fused score =
    cluster mean scaled by min(votes, M)/M. Returns (boxes, scores, labels)
    sorted by score."""
    m = num_models or len(boxes_list)
    boxes = np.concatenate([np.asarray(b, np.float64).reshape(-1, 4)
                            for b in boxes_list])
    scores = np.concatenate([np.asarray(s, np.float64) for s in scores_list])
    labels = np.concatenate([np.asarray(l, np.int64) for l in labels_list])
    order = np.argsort(-scores, kind="mergesort")
    boxes, scores, labels = boxes[order], scores[order], labels[order]

    out_b, out_s, out_l = [], [], []
    clusters = []  # per fused box: lists of member boxes/scores
    for box, score, label in zip(boxes, scores, labels):
        best, best_iou = -1, iou_thr
        for ci, (cb, _, cl) in enumerate(clusters):
            if cl != label:
                continue
            iou = _iou(out_b[ci], box[None])[0]
            if iou > best_iou:
                best, best_iou = ci, iou
        if best == -1:
            clusters.append(([box], [score], label))
            out_b.append(box.copy())
            out_s.append(score)
            out_l.append(label)
        else:
            cb, cs, _ = clusters[best]
            cb.append(box)
            cs.append(score)
            w = np.asarray(cs)[:, None]
            out_b[best] = (np.stack(cb) * w).sum(0) / w.sum()
            out_s[best] = float(np.mean(cs)) * min(len(cs), m) / m
    if not out_b:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)
    out_b = np.stack(out_b)
    out_s = np.asarray(out_s)
    out_l = np.asarray(out_l, np.int64)
    order = np.argsort(-out_s, kind="mergesort")
    return out_b[order], out_s[order], out_l[order]


def fuse_dumps(paths, iou_thr: float = 0.55) -> dict:
    dumps = []
    for p in paths:
        with open(p) as f:
            dumps.append(json.load(f))
    n_img = len(dumps[0]["images"])
    assert all(len(d["images"]) == n_img for d in dumps), (
        "dumps cover different image counts — same eval split required"
    )
    fused = {"num_classes": dumps[0]["num_classes"], "metrics": ["bbox"],
             "images": []}
    for i in range(n_img):
        dets = [d["images"][i]["det"] for d in dumps]
        b, s, l = weighted_boxes_fusion(
            [d["bboxes"] for d in dets],
            [d["scores"] for d in dets],
            [d["labels"] for d in dets],
            iou_thr=iou_thr, num_models=len(dumps),
        )
        rec = {
            "det": {"bboxes": b.tolist(), "scores": s.tolist(),
                    "labels": l.tolist()},
            "gt": {k: v for k, v in dumps[0]["images"][i]["gt"].items()
                   if k != "masks"},
        }
        if "meta" in dumps[0]["images"][i]:
            rec["meta"] = dumps[0]["images"][i]["meta"]
        fused["images"].append(rec)
    return fused


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if len(args.results) < 2:
        raise SystemExit("need at least two dumps to fuse")
    for p in args.results:
        r = evaluate_dump(p, metrics=["bbox"])
        print(f"{os.path.basename(p)}: bbox_mAP {r['coco/bbox_mAP']:.4f}")
    fused = fuse_dumps(args.results, args.iou_thr)
    out_path = args.out or "fused_results.json"
    with open(out_path, "w") as f:
        json.dump(fused, f)
    r = evaluate_dump(out_path, metrics=["bbox"])
    print(f"fused ({len(args.results)} models, iou_thr={args.iou_thr}): "
          f"bbox_mAP {r['coco/bbox_mAP']:.4f} -> {out_path}")
    return r


if __name__ == "__main__":
    main()
