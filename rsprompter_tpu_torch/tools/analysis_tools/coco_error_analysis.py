"""Decompose detection errors into the COCO-analyze waterfall.

    python -m rsprompter_tpu_torch.tools.analysis_tools.coco_error_analysis \\
        RESULTS.json [--metric bbox|segm] [--out curves.png]

The port's counterpart of the JAX package's
``tools/analysis_tools/coco_error_analysis.py`` (the reference's, after the
official coco-analyze recipe), over a ``tools.test --out`` dump: per class,
AP is measured again while one error type after another is forgiven --

  C75  AP at IoU .75
  C50  AP at IoU .50
  Loc  AP at IoU .10 (localisation errors forgiven)
  Oth  AP at IoU .10, every GT relabelled to the class (class confusion
       forgiven; the flat label spaces here have no supercategories, so the
       reference's Sim step falls into Oth)
  BG   the Oth run's maximum recall (background false positives forgiven)
  FN   1.0 (missed detections forgiven)

``--out`` draws the stacked bars with matplotlib where it imports, and says
that it skipped them where it does not (the card's machine has none).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.evaluation.coco_eval import CocoEvaluator
from rsprompter_tpu_torch.evaluation.coco_metric import from_jsonable

STAGES = ("C75", "C50", "Loc", "Oth", "BG", "FN")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="COCO error-type analysis")
    p.add_argument("results", help="JSON dump from tools.test --out")
    p.add_argument("--metric", default="bbox", choices=("bbox", "segm"))
    p.add_argument("--out", default=None, help="optional stacked-bar PNG")
    return p.parse_args(argv)


def analyze_dump(path: str, metric: str = "bbox") -> Dict[int, Dict[str, float]]:
    """-> {class: {C75, C50, Loc, Oth, BG, FN}} for the classes with GT."""
    with open(path) as f:
        dump = json.load(f)
    if metric not in dump["metrics"]:
        raise ValueError(f"{metric} not in dump (has {dump['metrics']})")
    nc = dump["num_classes"]
    images = [(from_jsonable(r["det"]), from_jsonable(r["gt"])) for r in dump["images"]]
    std = CocoEvaluator(nc, iou_type=metric)
    loc = CocoEvaluator(nc, iou_type=metric, iou_thrs=[0.1])
    for det, gt in images:
        std.add_image(det, gt)
        loc.add_image(det, gt)
    out = {}
    for c in range(nc):
        ap_std, _ = std._ap_recall(c, "all")
        ap_loc, _ = loc._ap_recall(c, "all")
        if ap_std is None:
            continue
        # Oth: the GT relabelled to c, the dets of class c only
        oth = CocoEvaluator(1, iou_type=metric, iou_thrs=[0.1])
        for det, gt in images:
            sel = np.asarray(det["labels"]) == c
            det_c = {
                "bboxes": np.asarray(det["bboxes"], np.float64).reshape(-1, 4)[sel],
                "scores": np.asarray(det["scores"])[sel],
                "labels": np.zeros(int(sel.sum()), np.int64),
            }
            if "masks" in det:
                det_c["masks"] = [m for m, s in zip(det["masks"], sel) if s]
            oth.add_image(det_c, dict(gt, labels=np.zeros(len(gt["labels"]), np.int64)))
        ap_oth, rec_oth = oth._ap_recall(0, "all")
        out[c] = {
            "C75": round(float(ap_std[5]), 4),
            "C50": round(float(ap_std[0]), 4),
            "Loc": round(float(ap_loc[0]), 4),
            "Oth": round(float(ap_oth[0]), 4) if ap_oth is not None else float("nan"),
            "BG": round(float(rec_oth[0]), 4) if rec_oth is not None else float("nan"),
            "FN": 1.0,
        }
    return out


def plot(per_class: Dict[int, Dict[str, float]], path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipped plot")
        return
    classes = sorted(per_class)
    x = np.arange(len(classes))
    plt.figure(figsize=(max(6, len(classes)), 4))
    prev = np.zeros(len(classes))
    for s in STAGES:
        vals = np.asarray([per_class[c][s] for c in classes])
        plt.bar(x, np.maximum(vals - prev, 0), bottom=prev, label=s)
        prev = np.maximum(vals, prev)
    plt.xticks(x, [str(c) for c in classes])
    plt.xlabel("class")
    plt.ylabel("AP (cumulative as errors are forgiven)")
    plt.legend(fontsize=8)
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    print(f"saved {path}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, Dict[str, float]]:
    args = parse_args(argv)
    per_class = analyze_dump(args.results, args.metric)
    if not per_class:
        raise SystemExit("no classes with ground truth in the dump")
    print("class  " + "  ".join(f"{s:>6}" for s in STAGES))
    for c, row in per_class.items():
        print(f"{c:>5}  " + "  ".join(f"{row[s]:6.3f}" for s in STAGES))
    mean = {s: float(np.nanmean([r[s] for r in per_class.values()])) for s in STAGES}
    print(" mean  " + "  ".join(f"{mean[s]:6.3f}" for s in STAGES))
    if args.out:
        plot(per_class, args.out)
    return per_class


if __name__ == "__main__":
    main()
