"""CocoMetric: detection/segmentation mAP over padded device outputs.

The port's copy of ``rsprompter_tpu/evaluation/coco_metric.py`` (``CocoMetric``
:23, ``_jsonable`` :148, ``from_jsonable`` :172, ``gt_from_raw_sample``
:189); its ``--out`` dump keeps JAX's JSON layout, so either package's
``from_jsonable`` reads the other's file. ``mask_mode='fullframe'`` only:
``'paste'`` needs SAM-seg Mask R-CNN's mask head, not ported yet.

Behavior parity: reference ``mmdet/evaluation/metrics/coco_metric.py:23`` —
``process`` RLE-encodes predicted masks per image (:364-367), ``compute``
runs COCO AP (:393) and emits ``coco/bbox_mAP``, ``coco/segm_mAP(_50/_75/...)``.
GT can come from the dataset's annotations (the GT-free path of :378-391 that
builds COCO structures from data samples maps to passing GT dicts directly).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.core.registry import METRICS
from rsprompter_tpu_torch.evaluation.coco_eval import CocoEvaluator
from rsprompter_tpu_torch.evaluation.rle import RLE, encode_masks
from rsprompter_tpu_torch.ops.masks import finalize_masks_np


@METRICS.register_module()
class CocoMetric:
    def __init__(
        self,
        num_classes: int,
        metric: Sequence[str] = ("bbox", "segm"),
        mask_thr: float = 0.5,
        mask_mode: str = "fullframe",  # SAM heads; 'paste' (FCN) raises
        dump_path: Optional[str] = None,
        classwise: bool = False,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.num_classes = num_classes
        self.metrics = tuple(metric)
        # classwise: also emit per-category AP keys (reference CocoMetric
        # classwise=True, mmdet/evaluation/metrics/coco_metric.py:527-559)
        self.classwise = classwise
        self.class_names = list(class_names or [])
        self.mask_thr = mask_thr
        if mask_mode != "fullframe":
            raise NotImplementedError(
                f"mask_mode={mask_mode!r} needs SAM-seg Mask R-CNN's mask head "
                "(paste_masks_np), not ported yet (ROADMAP A6)")
        self.evaluators = {
            m: CocoEvaluator(num_classes, iou_type=m) for m in self.metrics
        }
        # dump_path: write every processed (det, gt) pair as JSON at
        # compute() time for offline re-evaluation / error analysis
        # (tools/analysis_tools/eval_metric.py; reference
        # tools/test.py --out + tools/analysis_tools/eval_metric.py)
        self.dump_path = dump_path
        self._dump_records = [] if dump_path else None

    def process(
        self,
        metas: List[Dict],
        dets,
        mask_probs: Optional[np.ndarray] = None,
        gts: Optional[List[Dict]] = None,
    ) -> None:
        """Consume one batch of padded predictions.

        dets: DetResult-like with numpy-convertible (B, N, ...) fields.
        mask_probs: (B, N, S, S) sigmoid probs, u8 or float (fullframe).
        gts: per-image GT dicts {bboxes (ori coords), labels, masks (binary),
             iscrowd, areas}.
        """
        boxes = np.asarray(dets.boxes)
        scores = np.asarray(dets.scores)
        labels = np.asarray(dets.labels)
        valid = np.asarray(dets.valid)
        for i, meta in enumerate(metas):
            if meta.get("img_id", 0) == -1:
                continue  # padded batch slot
            keep = valid[i]
            ws, hs = meta["scale_factor"]
            det_boxes = boxes[i][keep] / np.array([ws, hs, ws, hs], np.float32)
            det = dict(
                bboxes=det_boxes,
                scores=scores[i][keep],
                labels=labels[i][keep],
            )
            if "segm" in self.metrics and mask_probs is not None:
                ori_h, ori_w = meta["ori_shape"]
                bin_masks = finalize_masks_np(
                    mask_probs[i][keep],
                    meta["batch_input_shape"],
                    (ori_h, ori_w),
                    meta["scale_factor"],
                    thr=self.mask_thr,
                )
                det["masks"] = encode_masks(bin_masks)
            gt = gts[i] if gts is not None else dict(
                bboxes=np.zeros((0, 4)), labels=np.zeros(0, np.int64)
            )
            if "segm" in self.metrics and "masks" in gt and not isinstance(
                gt["masks"], list
            ):
                gt = dict(gt, masks=encode_masks(np.asarray(gt["masks"])))
            for m in self.metrics:
                self.evaluators[m].add_image(det, gt)
            if self._dump_records is not None:
                self._dump_records.append(
                    {
                        "det": _jsonable(det),
                        "gt": _jsonable(gt),
                        "meta": {
                            "img_id": int(meta.get("img_id", i)),
                            "img_path": meta.get("img_path", ""),
                            "ori_shape": list(meta.get("ori_shape", ())),
                        },
                    }
                )

    def compute(self) -> Dict[str, float]:
        out = {}
        for m in self.metrics:
            for k, v in self.evaluators[m].summarize().items():
                out[f"coco/{k}"] = v
            if self.classwise:
                for c, ap in self.evaluators[m].per_class_ap().items():
                    name = (
                        self.class_names[c]
                        if c < len(self.class_names) else f"cls{c}"
                    )
                    out[f"coco/{m}_{name}_precision"] = ap["AP"]
        if self.dump_path:
            import json

            # json.dumps runs the C encoder; json.dump to a file runs the
            # pure-Python one, several times slower on 10^7 RLE counts
            with open(self.dump_path, "w") as f:
                f.write(json.dumps({
                    "num_classes": self.num_classes,
                    "metrics": list(self.metrics),
                    "images": self._dump_records,
                }))
        return out


def _jsonable(d: Dict) -> Dict:
    """Evaluator det/gt dict -> JSON-serializable (arrays to lists, RLEs to
    pycocotools-style dicts). Inverse: :func:`from_jsonable`."""
    out = {}
    for k, v in d.items():
        if k == "masks":
            # bbox-only runs carry GT masks as raw binary arrays (possibly a
            # list of per-instance bitmaps), never RLE-encoded by process;
            # encode here so the dump stays loadable (and ~500x smaller than
            # nested lists of pixels)
            if not isinstance(v, list):
                v = encode_masks(np.asarray(v).astype(np.uint8))
            out[k] = [
                r.to_coco() if hasattr(r, "to_coco")
                else encode_masks(np.asarray(r, np.uint8)[None])[0].to_coco()
                for r in v
            ]
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        else:
            out[k] = v
    return out


def from_jsonable(d: Dict) -> Dict:
    """JSON record (from a CocoMetric dump) -> evaluator det/gt dict."""
    out = {}
    for k, v in d.items():
        if k == "masks":
            out[k] = [RLE.from_coco(r) for r in v]
        elif k in ("labels",):
            out[k] = np.asarray(v, np.int64)
        elif k in ("iscrowd",):
            out[k] = np.asarray(v, bool)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def gt_from_raw_sample(raw: Dict) -> Dict:
    """Dataset ``load_raw`` output -> evaluator GT dict (ori-resolution).

    Areas come from the annotation 'area' field (segmentation area — what
    pycocotools' area-range ignore rule reads), not the bbox; bbox area is
    only the fallback for sources that don't carry it."""
    b = raw["gt_bboxes"]
    areas = raw.get("gt_areas")
    if areas is None:
        areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return dict(
        bboxes=b,
        labels=raw["gt_labels"],
        iscrowd=raw["gt_ignore_flags"],
        areas=areas,
        masks=raw["gt_masks"].astype(np.uint8),
    )
