"""The evaluation loop that ``tools.test`` and the runner's validation share.

Counterpart of the loops of ``rsprompter_tpu/tools/test.py`` (``main``
:178-228) and ``rsprompter_tpu/engine/runner.py`` (``validate`` :257-299):
each batch of the test-side loader is predicted on the inferencer's device
(``DetInferencer.predict_batch``, under ``utils.memory.oom_guard``: a batch
that runs the card out of memory is halved, as JAX guards both loops' predict,
``tools/test.py:202-204``, ``engine/runner.py:252-254``), its detections and
uint8 mask probabilities copied to the host and handed to ``CocoMetric``
with the GT of each raw sample at its original size. Beside
the metric it sums JAX's prediction digest (:284-298): the kept detections,
their mean score and their mean mask probability over every slot of each
batch, padded slots included, as JAX's validation counts them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from rsprompter_tpu_torch.evaluation.coco_metric import gt_from_raw_sample


def _to_host(dets):
    """The padded detections as numpy (floating fields as fp32)."""
    return type(dets)(*[(t.float() if t.is_floating_point() else t).cpu().numpy()
                        for t in dets])


def evaluate(inferencer, loader, metric) -> Dict[str, Any]:
    """Run ``loader`` through ``inferencer.predict_batch`` into ``metric``.

    Returns {'metrics': ``metric.compute()``, 'digest': the ``val/...`` keys,
    'timing': the loop's split (decode + GT wait, predict to the host copy,
    ``metric.process``, ``compute``, wall, images, and on the card the
    CUDA-event span of every predict in ``device_ms``)}."""
    on_card = inferencer.device.type == "cuda"
    timing = dict(load_s=0.0, predict_s=0.0, process_s=0.0, compute_s=0.0, device_ms=0.0)
    spans: List = []
    n_images = n_dets = 0
    score_sum = mask_prob_sum = 0.0
    t_start = time.perf_counter()
    t0 = t_start
    for samples, metas in loader:
        gts = [gt_from_raw_sample(s) for s in samples]
        gts += [None] * (len(metas) - len(samples))
        t1 = time.perf_counter()
        if on_card:  # the device's span of each predict
            spans.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            spans[-1][0].record()
        oracle = {"gts": samples} if inferencer.oracle else {}  # GT boxes as prompts
        dets, probs_u8, metas = inferencer.predict_batch([s["img"] for s in samples], metas,
                                                         **oracle)
        if on_card:
            spans[-1][1].record()
        dets_np, probs_np = _to_host(dets), probs_u8.cpu().numpy()
        t2 = time.perf_counter()
        metric.process(metas, dets_np, probs_np, gts)
        valid = np.asarray(dets_np.valid, bool)[: len(metas)]
        n_dets += int(valid.sum())
        score_sum += float(np.asarray(dets_np.scores)[: len(metas)][valid].sum())
        if valid.any():
            m = float(probs_np[: len(metas)][valid].mean(dtype=np.float64)) / 255.0
            mask_prob_sum += m * int(valid.sum())
        t3 = time.perf_counter()
        timing["load_s"] += t1 - t0
        timing["predict_s"] += t2 - t1
        timing["process_s"] += t3 - t2
        n_images += len(samples)
        t0 = time.perf_counter()
    results = metric.compute()
    t_end = time.perf_counter()
    timing["compute_s"] = t_end - t0
    timing["wall_s"] = t_end - t_start
    timing["images"] = n_images
    timing["device_ms"] = sum(a.elapsed_time(b) for a, b in spans)
    digest = {"val/num_dets": float(n_dets),
              "val/mean_score": score_sum / max(n_dets, 1),
              "val/mean_mask_prob": mask_prob_sum / max(n_dets, 1)}
    return dict(metrics=results, digest=digest, timing=timing)
