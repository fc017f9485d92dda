"""COCO-style AP evaluation (pycocotools-COCOeval-compatible, numpy + native RLE).

The port's copy of ``rsprompter_tpu/evaluation/coco_eval.py``
(``bbox_iou_np`` :29, ``_match_image`` :43, the native matcher :106,
``CocoEvaluator`` :114), which replaces the reference's pycocotools
(``mmdet/evaluation/metrics/coco_metric.py:393`` runs COCOeval): greedy
score-ordered matching with crowd and ignore semantics, 101-point
interpolated PR curves, IoU thresholds .5:.05:.95 (or a custom ladder), area
ranges all / small / medium / large and maxDets 100. Mask IoU and the greedy
match run in the native library (``evaluation/rle.py``), which raises where
it cannot be built.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from rsprompter_tpu_torch.evaluation.rle import iou_matrix, load_library

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def bbox_iou_np(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xyxy IoU; crowd gts use det-area denominator (IoF), like pycocotools."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    da = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    ga = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(iscrowd[None, :], da[:, None], da[:, None] + ga[None, :] - inter)
    return np.where(union > 0, inter / union, 0.0)


def _match_image(
    ious: np.ndarray,  # (D, G) det-score-desc x gt (non-ignored first)
    gt_ignore: np.ndarray,  # (G,)
    gt_crowd: np.ndarray,  # (G,)
    det_areas: np.ndarray,  # (D,)
    area_rng,
    iou_thrs: np.ndarray = IOU_THRS,
):
    """Returns (dt_matched (T, D) bool, dt_ignore (T, D) bool) per IoU thr.

    The greedy loop runs in the native library (the part pycocotools runs
    in C); :func:`match_greedy_plain` is its plain version."""
    d, g = ious.shape
    t = len(iou_thrs)
    dtm = np.full((t, d), -1, np.int64)
    dt_ig = np.zeros((t, d), bool)
    if d and g:
        dtm, dt_ig = match_greedy(ious, gt_ignore, gt_crowd, iou_thrs)
    # unmatched dets outside the area range are ignored
    out_of_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
    dt_ig |= (dtm == -1) & out_of_rng[None, :]
    return dtm >= 0, dt_ig


def match_greedy(ious, gt_ignore, gt_crowd, iou_thrs):
    """The native greedy matcher: (dtm (T, D) matched gt index or -1,
    dt_ignore (T, D) bool)."""
    d, g = ious.shape
    t = len(iou_thrs)
    ious_c = np.ascontiguousarray(ious, np.float64)
    gi_c = np.ascontiguousarray(gt_ignore, np.uint8)
    gc_c = np.ascontiguousarray(gt_crowd, np.uint8)
    thrs_c = np.ascontiguousarray(iou_thrs, np.float64)
    dtm = np.empty((t, d), np.int64)
    dt_ig = np.empty((t, d), np.uint8)
    f64p, u8p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)
    load_library().match_image(
        ious_c.ctypes.data_as(f64p), d, g, gi_c.ctypes.data_as(u8p),
        gc_c.ctypes.data_as(u8p), thrs_c.ctypes.data_as(f64p), t,
        dtm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), dt_ig.ctypes.data_as(u8p),
    )
    return dtm, dt_ig.astype(bool)


def match_greedy_plain(ious, gt_ignore, gt_crowd, iou_thrs):
    """Plain version of :func:`match_greedy` (the Python loop JAX keeps)."""
    d, g = ious.shape
    t = len(iou_thrs)
    dtm = np.zeros((t, d), dtype=np.int64) - 1
    gtm = np.zeros((t, g), dtype=np.int64) - 1
    dt_ig = np.zeros((t, d), bool)
    for ti, thr in enumerate(iou_thrs):
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g):
                if gtm[ti, gi] >= 0 and not gt_crowd[gi]:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break  # gts sorted: past non-ignored, stop improving
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            gtm[ti, m] = di
            dt_ig[ti, di] = gt_ignore[m]
    return dtm, dt_ig


class CocoEvaluator:
    """Accumulates per-image results and computes AP.

    ``add_image(dets, gts)`` per image:
      dets: {'bboxes' (D,4) xyxy, 'scores' (D,), 'labels' (D,),
             'masks': list[RLE] (for segm)}
      gts:  {'bboxes', 'labels', 'iscrowd' (G,), 'areas' (G,),
             'masks': list[RLE]}
    """

    def __init__(self, num_classes: int, iou_type: str = "bbox",
                 max_dets: int = 100, iou_thrs=None):
        assert iou_type in ("bbox", "segm")
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.max_dets = max_dets
        # custom iou_thrs (e.g. [0.1] for localization-error analysis);
        # summarize()/per_class_ap() look up the .5/.75 columns and report
        # NaN when the ladder lacks them
        self.iou_thrs = np.asarray(iou_thrs if iou_thrs is not None else IOU_THRS)
        # per (class, area) lists over images
        self._results: Dict = {
            (c, a): {"scores": [], "matched": [], "ignored": [], "npig": 0}
            for c in range(num_classes)
            for a in AREA_RANGES
        }

    def add_image(self, dets: Dict, gts: Dict) -> None:
        d_labels = np.asarray(dets["labels"], np.int64)
        d_scores = np.asarray(dets["scores"], np.float64)
        g_labels = np.asarray(gts["labels"], np.int64)
        g_crowd = np.asarray(gts.get("iscrowd", np.zeros(len(g_labels), bool)), bool)
        g_areas = np.asarray(
            gts.get(
                "areas",
                (np.asarray(gts["bboxes"])[:, 2] - np.asarray(gts["bboxes"])[:, 0])
                * (np.asarray(gts["bboxes"])[:, 3] - np.asarray(gts["bboxes"])[:, 1])
                if len(g_labels)
                else np.zeros(0),
            ),
            np.float64,
        )
        d_boxes = np.asarray(dets["bboxes"], np.float64).reshape(-1, 4)
        g_boxes = np.asarray(gts["bboxes"], np.float64).reshape(-1, 4)
        d_areas_box = (d_boxes[:, 2] - d_boxes[:, 0]) * (d_boxes[:, 3] - d_boxes[:, 1])

        for c in range(self.num_classes):
            dsel = np.flatnonzero(d_labels == c)
            gsel = np.flatnonzero(g_labels == c)
            dsel = dsel[np.argsort(-d_scores[dsel], kind="mergesort")][: self.max_dets]
            for aname, arng in AREA_RANGES.items():
                g_ignore = g_crowd[gsel] | (g_areas[gsel] < arng[0]) | (
                    g_areas[gsel] > arng[1]
                )
                order = np.argsort(g_ignore, kind="mergesort")  # non-ignored first
                gsel_o = gsel[order]
                g_ignore_o = g_ignore[order]
                if self.iou_type == "bbox":
                    ious = bbox_iou_np(
                        d_boxes[dsel], g_boxes[gsel_o], g_crowd[gsel_o]
                    )
                    det_a = d_areas_box[dsel]
                else:
                    d_rles = [dets["masks"][i] for i in dsel]
                    g_rles = [gts["masks"][i] for i in gsel_o]
                    ious = iou_matrix(d_rles, g_rles, g_crowd[gsel_o])
                    det_a = np.asarray([r.area() for r in d_rles], np.float64)
                matched, ignored = _match_image(
                    ious, g_ignore_o, g_crowd[gsel_o], det_a, arng,
                    self.iou_thrs,
                )
                slot = self._results[(c, aname)]
                slot["scores"].append(d_scores[dsel])
                slot["matched"].append(matched)
                slot["ignored"].append(ignored)
                slot["npig"] += int((~g_ignore_o).sum())

    def _ap_recall(self, c: int, aname: str):
        slot = self._results[(c, aname)]
        npig = slot["npig"]
        if npig == 0:
            return None, None
        scores = np.concatenate(slot["scores"]) if slot["scores"] else np.zeros(0)
        t = len(self.iou_thrs)
        matched = (
            np.concatenate(slot["matched"], axis=1)
            if slot["matched"]
            else np.zeros((t, 0), bool)
        )
        ignored = (
            np.concatenate(slot["ignored"], axis=1)
            if slot["ignored"]
            else np.zeros((t, 0), bool)
        )
        order = np.argsort(-scores, kind="mergesort")
        matched, ignored = matched[:, order], ignored[:, order]
        tp = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
        fp = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)
        ap = np.zeros(t)
        rec = np.zeros(t)
        for ti in range(t):
            nd = tp[ti].size
            rc = tp[ti] / npig
            pr = tp[ti] / np.maximum(tp[ti] + fp[ti], np.spacing(1))
            rec[ti] = rc[-1] if nd else 0.0
            # precision envelope
            for i in range(nd - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            valid = inds < nd
            q[valid] = pr[inds[valid]]
            ap[ti] = q.mean()
        return ap, rec

    def _thr_idx(self, thr: float):
        """Index of ``thr`` in this evaluator's IoU ladder, or None (custom
        ladders may not contain .5/.75)."""
        idx = np.flatnonzero(np.isclose(self.iou_thrs, thr))
        return int(idx[0]) if len(idx) else None

    def per_class_ap(self) -> Dict[int, Dict[str, float]]:
        """Per-category AP over the 'all' area range (the reference's
        ``classwise=True`` table, ``coco_metric.py:527-559``):
        {class_idx: {AP, AP50, AP75}} (NaN for classes with no GT, and for
        AP50/AP75 when a custom iou_thrs ladder lacks those thresholds)."""
        i50, i75 = self._thr_idx(0.5), self._thr_idx(0.75)
        out = {}
        for c in range(self.num_classes):
            ap, _ = self._ap_recall(c, "all")
            if ap is None:
                out[c] = {"AP": float("nan"), "AP50": float("nan"),
                          "AP75": float("nan")}
            else:
                out[c] = {
                    "AP": round(float(ap.mean()), 4),
                    "AP50": round(float(ap[i50]), 4) if i50 is not None
                    else float("nan"),
                    "AP75": round(float(ap[i75]), 4) if i75 is not None
                    else float("nan"),
                }
        return out

    def summarize(self) -> Dict[str, float]:
        per_cls = {a: [] for a in AREA_RANGES}
        for c in range(self.num_classes):
            for a in AREA_RANGES:
                ap, _ = self._ap_recall(c, a)
                if ap is not None:
                    per_cls[a].append(ap)

        def mean_ap(a, thr_idx=None):
            if not per_cls[a]:
                return float("nan")
            arr = np.stack(per_cls[a])  # (C, T)
            return float(arr.mean() if thr_idx is None else arr[:, thr_idx].mean())

        p = self.iou_type
        i50, i75 = self._thr_idx(0.5), self._thr_idx(0.75)
        return {
            f"{p}_mAP": round(mean_ap("all"), 4),
            f"{p}_mAP_50": round(mean_ap("all", i50), 4)
            if i50 is not None else float("nan"),
            f"{p}_mAP_75": round(mean_ap("all", i75), 4)
            if i75 is not None else float("nan"),
            f"{p}_mAP_s": round(mean_ap("small"), 4),
            f"{p}_mAP_m": round(mean_ap("medium"), 4),
            f"{p}_mAP_l": round(mean_ap("large"), 4),
        }
