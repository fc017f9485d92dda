"""Confusion matrix of a detector's predictions over its test set.

    python -m rsprompter_tpu_torch.tools.analysis_tools.confusion_matrix CONFIG [CKPT] \\
        [--out-dir DIR] [--score-thr 0.3] [--tp-iou-thr 0.5] \\
        [--cfg-options k=v ...] [--device cuda|cpu]

The port's counterpart of the JAX package's
``tools/analysis_tools/confusion_matrix.py`` (the reference's): the test
set (``test_dataloader``, else ``val_dataloader``) runs through
``DetInferencer`` on the port's loader, and each image's predictions over
``--score-thr`` meet its GT in a (classes + 1)^2 matrix, the last row and
column background. Each GT takes every prediction of IoU >= ``--tp-iou-thr``,
best first; a prediction nothing took is a false positive (background row),
a GT that took none a miss (background column). Rows are GT, columns
predictions. Writes ``confusion_matrix.npy`` and, where matplotlib imports,
``confusion_matrix.png``. ``CKPT`` is what ``tools.test`` loads. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.apis.inference import init_detector, resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.loader import DataLoader
from rsprompter_tpu_torch.evaluation.loop import _to_host
from rsprompter_tpu_torch.tools.test import load_checkpoint


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Confusion matrix")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out-dir", default="./work_dirs/confusion")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--tp-iou-thr", type=float, default=0.5)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def bbox_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4), (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=-1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def accumulate(confusion: np.ndarray, pred_boxes: np.ndarray, pred_labels: np.ndarray,
               pred_scores: np.ndarray, gt_boxes: np.ndarray, gt_labels: np.ndarray,
               score_thr: float, tp_iou_thr: float) -> None:
    """Add one image to ``confusion`` (C + 1, C + 1) in place."""
    nc = confusion.shape[0] - 1
    keep = pred_scores >= score_thr
    pred_boxes, pred_labels = pred_boxes[keep], pred_labels[keep]
    ious = bbox_iou(gt_boxes, pred_boxes)  # (G, P)
    gt_hit = np.zeros(len(gt_boxes), bool)
    pred_hit = np.zeros(len(pred_boxes), bool)
    for gi in range(len(gt_boxes)):
        for pi in np.argsort(-ious[gi]):
            if ious[gi, pi] < tp_iou_thr:
                break
            confusion[gt_labels[gi], pred_labels[pi]] += 1
            gt_hit[gi] = True
            pred_hit[pi] = True
    for gi in np.flatnonzero(~gt_hit):
        confusion[gt_labels[gi], nc] += 1  # a missed GT: background column
    for pi in np.flatnonzero(~pred_hit):
        confusion[nc, pred_labels[pi]] += 1  # a false positive: background row


def plot(confusion: np.ndarray, classes: Sequence[str], out_path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipped plot")
        return
    norm = confusion / np.maximum(confusion.sum(axis=1, keepdims=True), 1)
    labels = list(classes) + ["background"]
    fig, ax = plt.subplots(figsize=(0.8 * len(labels) + 2,) * 2)
    im = ax.imshow(norm, cmap="plasma", vmin=0, vmax=1)
    ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
    ax.set_yticks(range(len(labels)), labels)
    ax.set_xlabel("prediction")
    ax.set_ylabel("ground truth")
    for i in range(len(labels)):
        for j in range(len(labels)):
            ax.text(j, i, f"{norm[i, j]:.2f}", ha="center", va="center",
                    color="w" if norm[i, j] < 0.5 else "k", fontsize=7)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    print(f"wrote {out_path}")


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    batch_size = cfg.get("val_dataloader", {}).get("batch_size", 2)
    inferencer = init_detector(cfg, device=resolve_device(args.device), batch_size=batch_size)
    if args.checkpoint:
        load_checkpoint(inferencer.model, args.checkpoint)
    dataset = DATASETS.build(dict((cfg.get("test_dataloader") or cfg["val_dataloader"])["dataset"]))
    classes = dataset.metainfo.get("classes", ())
    nc = len(classes) or cfg["model"].get("num_classes", 1)
    confusion = np.zeros((nc + 1, nc + 1), np.int64)
    for samples, metas in DataLoader(dataset, batch_size=batch_size, prefetch=1):
        dets, _, metas = inferencer.predict_batch([s["img"] for s in samples], metas)
        dets = _to_host(dets)
        for bi, raw in enumerate(samples):
            ws, hs = metas[bi]["scale_factor"]
            valid = np.asarray(dets.valid[bi])
            accumulate(confusion, dets.boxes[bi][valid] / np.array([ws, hs, ws, hs]),
                       dets.labels[bi][valid].astype(int), dets.scores[bi][valid],
                       np.asarray(raw["gt_bboxes"], np.float32).reshape(-1, 4),
                       np.asarray(raw["gt_labels"], int).reshape(-1),
                       args.score_thr, args.tp_iou_thr)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "confusion_matrix.npy"), confusion)
    print(confusion)
    plot(confusion, classes, os.path.join(args.out_dir, "confusion_matrix.png"))
    return confusion


if __name__ == "__main__":
    main()
