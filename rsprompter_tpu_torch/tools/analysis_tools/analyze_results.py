"""Rank evaluated images by their own AP and draw the best and the worst.

    python -m rsprompter_tpu_torch.tools.analysis_tools.analyze_results RESULTS.json \\
        --out-dir DIR [--topk 5] [--show-score-thr 0.3]

The port's counterpart of the JAX package's
``tools/analysis_tools/analyze_results.py`` (the reference's: score each
image by its own mAP, save the top-k 'good' and bottom-k 'bad' drawings),
over a ``tools.test --out`` dump instead of a pkl and a rebuilt dataset.
Writes ``good/NAME_{ap}.jpg`` and ``bad/NAME_{ap}.jpg``: the predictions over
``--show-score-thr`` drawn over the original image (``apis.visualization``;
the masks from the dump's RLE, ``evaluation.rle``), the ground truth in thin
white boxes, JPEG at quality 95 through the port's encoder.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from rsprompter_tpu_torch.apis.visualization import draw_box, draw_predictions
from rsprompter_tpu_torch.data.io import imread, imwrite
from rsprompter_tpu_torch.evaluation.coco_eval import CocoEvaluator
from rsprompter_tpu_torch.evaluation.coco_metric import from_jsonable
from rsprompter_tpu_torch.evaluation.rle import RLE, decode_mask

GT_COLOR = (255, 255, 255)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="rank and draw evaluation results")
    p.add_argument("results", help="JSON dump from tools.test --out")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--show-score-thr", type=float, default=0.3)
    return p.parse_args(argv)


def per_image_ap(dump: Dict[str, Any]) -> List[Tuple[float, Dict[str, Any]]]:
    """-> [(bbox mAP or NaN, record)], one a dumped image."""
    scored = []
    for rec in dump["images"]:
        ev = CocoEvaluator(dump["num_classes"], iou_type="bbox")
        ev.add_image(from_jsonable(rec["det"]), from_jsonable(rec["gt"]))
        scored.append((ev.summarize()["bbox_mAP"], rec))
    return scored


def render(rec: Dict[str, Any], score_thr: float) -> np.ndarray:
    img = imread(rec["meta"]["img_path"])
    det = rec["det"]
    scores = np.asarray(det["scores"], np.float32)
    keep = scores > score_thr
    pred = dict(
        bboxes=np.asarray(det["bboxes"], np.float32).reshape(-1, 4)[keep].tolist(),
        scores=scores[keep].tolist(),
        labels=np.asarray(det["labels"], np.int64)[keep].tolist(),
    )
    if det.get("masks"):
        masks = np.stack([decode_mask(RLE.from_coco(m)) for m in det["masks"]])
        pred["masks"] = masks[keep].astype(bool)
    vis = draw_predictions(img, pred)
    for box in np.asarray(rec["gt"]["bboxes"], np.float32).reshape(-1, 4):
        draw_box(vis, box, GT_COLOR, thickness=1)
    return vis


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[str]]:
    args = parse_args(argv)
    with open(args.results) as f:
        dump = json.load(f)
    if not dump["images"] or "meta" not in dump["images"][0]:
        raise SystemExit("dump has no image metadata (run tools.test --out again)")
    scored = sorted(((ap, rec) for ap, rec in per_image_ap(dump) if not np.isnan(ap)),
                    key=lambda t: t[0])
    written: Dict[str, List[str]] = {}
    for group, sel in (("bad", scored[: args.topk]), ("good", scored[-args.topk:][::-1])):
        gdir = os.path.join(args.out_dir, group)
        os.makedirs(gdir, exist_ok=True)
        written[group] = []
        for ap, rec in sel:
            base = os.path.splitext(os.path.basename(rec["meta"]["img_path"])
                                    or f"img_{rec['meta']['img_id']}")[0]
            name = f"{base}_{ap:.3f}.jpg"
            imwrite(os.path.join(gdir, name), render(rec, args.show_score_thr))
            written[group].append(name)
            print(f"{group}: {name}")
    return written


if __name__ == "__main__":
    main()
