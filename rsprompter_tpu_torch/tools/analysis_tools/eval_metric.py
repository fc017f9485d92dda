"""Offline re-evaluation of a ``tools.test --out`` dump (no model, no device).

    python -m rsprompter_tpu_torch.tools.analysis_tools.eval_metric RESULTS.json \\
        [--metrics bbox segm] [--classwise]

The port's counterpart of the JAX package's
``tools/analysis_tools/eval_metric.py`` (the reference's re-run of the
evaluator over ``tools/test.py --out``): the dump is self-contained JSON
(detections, RLE masks, ground truth), so no config or dataset is rebuilt.
The port's ``evaluation.coco_eval.CocoEvaluator`` scores it.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from rsprompter_tpu_torch.evaluation.coco_eval import CocoEvaluator
from rsprompter_tpu_torch.evaluation.coco_metric import from_jsonable


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="re-evaluate dumped results")
    p.add_argument("results", help="JSON dump from tools.test --out")
    p.add_argument("--metrics", nargs="+", default=None,
                   help="subset of the dump's metrics (default: all)")
    p.add_argument("--classwise", action="store_true", help="also report per-category AP")
    return p.parse_args(argv)


def evaluate_dump(path: str, metrics: Optional[Sequence[str]] = None,
                  classwise: bool = False) -> Dict[str, float]:
    with open(path) as f:
        dump = json.load(f)
    metrics = tuple(metrics or dump["metrics"])
    unknown = set(metrics) - set(dump["metrics"])
    if unknown:
        raise ValueError(f"metrics {sorted(unknown)} not in dump (has {dump['metrics']})")
    evaluators = {m: CocoEvaluator(dump["num_classes"], iou_type=m) for m in metrics}
    for rec in dump["images"]:
        det, gt = from_jsonable(rec["det"]), from_jsonable(rec["gt"])
        for ev in evaluators.values():
            ev.add_image(det, gt)
    out = {}
    for m, ev in evaluators.items():
        for k, v in ev.summarize().items():
            out[f"coco/{k}"] = v
        if classwise:
            for c, ap in ev.per_class_ap().items():
                out[f"coco/{m}_cls{c}_precision"] = ap["AP"]
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    out = evaluate_dump(args.results, args.metrics, args.classwise)
    for k, v in out.items():
        print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    main()
