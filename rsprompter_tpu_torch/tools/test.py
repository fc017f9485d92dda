"""Evaluate a detector: COCO bbox and segm mAP of a config's test set.

    python -m rsprompter_tpu_torch.tools.test CONFIG [CHECKPOINT] \\
        [--cfg-options k=v ...] [--classwise] [--out PATH] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/test.py`` (``main``
:84-228), for the detectors the port predicts (``RSPrompterAnchor``,
``RSPrompterQuery`` on either ``attn_impl`` route). The model is built by
``init_detector`` (seeded init, then the config's SAM file where it exists);
a ``CHECKPOINT`` is told by its keys: a file whose names the reference map
renames is a reference-trained mmengine file
(``engine.checkpoint.load_reference_checkpoint``, strict), any other the
port's own state_dict (``load_state_dict(strict=True)``).
The config's ``test_dataloader`` (else ``val_dataloader``) dataset is read
in order, ``val_dataloader.batch_size`` images a batch, the next batch
decoded in a background thread; each batch is predicted on the device,
quantised to uint8 and handed to ``CocoMetric`` with the GT of
``load_raw`` at the original size. Prints the same ``coco/...`` keys as the
JAX tool, then one line with the loop's throughput and where its time went.

Runs on the card unless ``--device cpu`` is given. Not taken (argparse
refuses them): ``--tta``, ``--oracle``, ``--show-dir``, ``--corruption`` /
``--severity`` and the multi-device mesh (ROADMAP A6, A7).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from rsprompter_tpu_torch.apis.inference import init_detector, resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.loader import DataLoader
from rsprompter_tpu_torch.engine.checkpoint import (
    load_reference_checkpoint, load_torch_checkpoint, revise_keys, split_packed_mha)
from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric, gt_from_raw_sample


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test a detector (COCO bbox + segm mAP)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--classwise", action="store_true",
                   help="also report per-category AP (reference CocoMetric(classwise=True))")
    p.add_argument("--out", default=None,
                   help="dump every (prediction, GT) pair as JSON in the JAX package's "
                        "layout, for offline re-evaluation")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def load_checkpoint(model: torch.nn.Module, path: str) -> str:
    """Load ``path`` into ``model``: 'reference' for a file whose names the
    reference map renames (the ``backbone.vision_encoder.`` wrapper, packed
    ``attn.in_proj_*``, a ``module.`` prefix), which no name of the port's
    has; else 'port', where ``load_state_dict(strict=True)`` names any key
    the file lacks or has too many."""
    sd = load_torch_checkpoint(path)
    renamed = split_packed_mha(revise_keys(sd))
    if any(k not in renamed for k in sd):
        load_reference_checkpoint(model, sd, strict=True)
        return "reference"
    model.load_state_dict(sd, strict=True)
    return "port"


def _to_host(dets):
    """The padded detections as numpy (floating fields as fp32)."""
    return type(dets)(*[(t.float() if t.is_floating_point() else t).cpu().numpy()
                        for t in dets])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the evaluation; returns {'metrics', 'timing', 'inferencer'}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)

    batch_size = cfg.get("val_dataloader", {}).get("batch_size", 2)
    inferencer = init_detector(cfg, device=device, batch_size=batch_size)
    if args.checkpoint:
        kind = load_checkpoint(inferencer.model, args.checkpoint)
        print(f"loaded {kind} checkpoint {args.checkpoint}")

    ds_cfg = dict((cfg.get("test_dataloader") or cfg["val_dataloader"])["dataset"])
    dataset = DATASETS.build(ds_cfg)
    loader = DataLoader(dataset, batch_size=batch_size, prefetch=1)
    metric = CocoMetric(
        num_classes=cfg["model"].get("num_classes", 1), dump_path=args.out,
        classwise=args.classwise, class_names=(dataset.metainfo or {}).get("classes"),
    )

    timing = dict(load_s=0.0, predict_s=0.0, process_s=0.0, compute_s=0.0, device_ms=0.0)
    spans: List = []
    n_images = 0
    t_start = time.perf_counter()
    t0 = t_start
    for samples, metas in loader:
        gts = [gt_from_raw_sample(s) for s in samples]
        gts += [None] * (len(metas) - len(samples))
        t1 = time.perf_counter()
        if device.type == "cuda":  # the device's span of each predict
            spans.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            spans[-1][0].record()
        dets, probs_u8, metas = inferencer.predict_batch([s["img"] for s in samples], metas)
        if device.type == "cuda":
            spans[-1][1].record()
        dets_np, probs_np = _to_host(dets), probs_u8.cpu().numpy()
        t2 = time.perf_counter()
        metric.process(metas, dets_np, probs_np, gts)
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
    for k, v in results.items():
        print(f"{k}: {v}")
    print(f"{n_images} images in {timing['wall_s']:.3f} s "
          f"({n_images / timing['wall_s']:.3f} images/s) on {device}: decode + GT "
          f"{timing['load_s']:.3f} s (waiting on the loader), predict {timing['predict_s']:.3f} s, "
          f"metric.process {timing['process_s']:.3f} s, compute {timing['compute_s']:.3f} s")
    return dict(metrics=results, timing=timing, inferencer=inferencer)


if __name__ == "__main__":
    main()
