"""Evaluate a detector: COCO bbox and segm mAP of a config's test set.

    python -m rsprompter_tpu_torch.tools.test CONFIG [CHECKPOINT] \\
        [--cfg-options k=v ...] [--classwise] [--out PATH] [--oracle] \\
        [--tta] [--corruption NAME --severity S] [--show-dir DIR] \\
        [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/test.py`` (``main``
:84-228), for every detector family (``RSPrompterAnchor``,
``RSPrompterQuery`` on either ``attn_impl`` route, ``SAMDet``,
``SAMSegMaskRCNN``, ``SAMSegMask2Former``). ``--oracle`` runs SAM-det's
``oracle_predict``: the batch carries each image's ground-truth boxes, which
prompt SAM at score 1. SAM-seg Mask R-CNN's RoI masks are pasted into their
boxes (``CocoMetric(mask_mode='paste')``); JAX's tool builds its metric
without ``mask_mode`` (:208) and so stretches each 28^2 map over the whole
image, a fault of the reference package. The model is built by
``init_detector`` (seeded init, then the config's SAM file where it exists);
a ``CHECKPOINT`` is the port's train checkpoint (``tools.train``'s
``WORK_DIR/ckpts/step_{n}`` or its ``state.pt``: parameters and BN
buffers), or a file told by its keys: one whose names the reference map
renames, or a SAM-det one with names it has no rule for, is a
reference-trained mmengine file (``engine.checkpoint.load_reference_checkpoint``,
strict; it raises for SAM-det), any other the port's own state_dict
(``load_state_dict(strict=True)``).
The config's ``test_dataloader`` (else ``val_dataloader``) dataset is read
in order, ``val_dataloader.batch_size`` images a batch, the next batch
decoded in a background thread; ``evaluation.loop.evaluate`` (the loop the
train runner's validation runs too) predicts each batch on the device,
quantises it to uint8 and hands it to ``CocoMetric`` with the GT of
``load_raw`` at the original size. Prints the same ``coco/...`` keys as the
JAX tool, then one line with the loop's throughput and where its time went.

The evaluation options, with JAX's flags and defaults (:21-32):

- ``--tta``: horizontal-flip test-time augmentation (``models.tta``): each
  batch and its mirror are predicted and merged by per-class NMS with
  ``model.test_cfg.rcnn``'s ``nms_iou_thr`` and ``max_per_img`` (0.5, 100
  where absent). Refused beside ``--oracle``, as JAX refuses it.
- ``--corruption NAME --severity S`` (1-5, default 1): each raw image is
  corrupted (``data.corruptions``) as float32 before the batch is made,
  with the seed ``img_id``, the order JAX's pipeline applies it in; the
  ground truth is untouched.
- ``--show-dir DIR``: each image's detections over a score of 0.3 drawn over
  its original file (``apis.visualization.draw_slot``) and written under
  the image's basename, JPEG at quality 95 for a ``.jpg`` through the port's
  encoder, as JAX's ``cv2.imwrite`` writes it.

Runs on the card unless ``--device cpu`` is given. Sharded over N GPUs of
one host, one process each (JAX :110-199):

    python -m torch.distributed.run --nproc_per_node N \
        -m rsprompter_tpu_torch.tools.test CONFIG [CHECKPOINT] [...]

Each rank predicts one block of the set (``DataLoader(shard_id=rank,
num_shards=world)``, ``val_dataloader.batch_size`` images a batch per
device) and processes it into the metric; the per-image results go to rank
0 in dataset order, which computes COCO (``evaluation.loop``); every image
is counted once. Rank 0 prints the metrics and writes ``--out``; each rank
draws its own images into ``--show-dir``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence

import torch

from rsprompter_tpu_torch.apis.inference import init_detector, resolve_device
from rsprompter_tpu_torch.apis.visualization import draw_slot
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.corruptions import CORRUPTIONS, CorruptImage
from rsprompter_tpu_torch.data.io import drawn_name
from rsprompter_tpu_torch.data.loader import DataLoader
from rsprompter_tpu_torch.engine.checkpoint import (
    CKPT_FILE, is_reference_state_dict, load_reference_checkpoint, load_torch_checkpoint,
    restore_train_params)
from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric
from rsprompter_tpu_torch.evaluation.loop import _to_host, evaluate  # noqa: F401
from rsprompter_tpu_torch.models.tta import make_tta_predict, tta_settings
from rsprompter_tpu_torch.parallel import distributed
from rsprompter_tpu_torch.parallel.mesh import mesh_from_config


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
    p.add_argument("--oracle", action="store_true",
                   help="SAM-det oracle mode: the ground-truth boxes, at score 1, prompt SAM")
    p.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation (reference tools/test.py --tta "
                        "/ DetTTAModel)")
    p.add_argument("--show-dir", default=None,
                   help="draw each image's predictions over it into this directory")
    p.add_argument("--corruption", default=None, choices=CORRUPTIONS,
                   help="corrupt each image before the pipeline (robustness benchmark; "
                        "see data/corruptions.py)")
    p.add_argument("--severity", type=int, default=1, choices=range(1, 6))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.tta and args.oracle:
        p.error("--tta and --oracle are mutually exclusive: the TTA predict always runs "
                "predict, which would ignore --oracle")
    return args


def load_checkpoint(model: torch.nn.Module, path: str) -> str:
    """Load ``path`` into ``model``: 'train' for the port's own train
    checkpoint (a ``step_{n}`` directory of ``tools.train``, or its
    ``state.pt``), whose parameters and BN buffers are restored and whose
    optimizer state is left, as JAX's ``restore_train_params`` path does;
    'reference' for a file whose names the reference map renames (the
    ``backbone.vision_encoder.`` wrapper, packed ``attn.in_proj_*``, a
    ``module.`` prefix), which no name of the port's has, or that holds
    SAM-det's unmapped ``detector.*`` (which raises); else 'port', where
    ``load_state_dict(strict=True)`` names any key the file lacks or has too
    many."""
    if os.path.isdir(path) or os.path.basename(path) == CKPT_FILE:
        model.load_state_dict(restore_train_params(path), strict=True)
        return "train"
    sd = load_torch_checkpoint(path)
    if is_reference_state_dict(sd):
        load_reference_checkpoint(model, sd, strict=True)
        return "reference"
    model.load_state_dict(sd, strict=True)
    return "port"


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the evaluation; returns {'metrics', 'digest', 'timing', 'inferencer'}."""
    args = parse_args(argv)
    device = distributed.initialize(resolve_device(args.device))
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    world, _ = mesh_from_config(cfg.get("dist"))
    main_rank = distributed.is_main()

    batch_size = cfg.get("val_dataloader", {}).get("batch_size", 2)
    inferencer = init_detector(cfg, device=device, batch_size=batch_size)
    if args.checkpoint:
        kind = load_checkpoint(inferencer.model, args.checkpoint)
        if main_rank:
            print(f"loaded {kind} checkpoint {args.checkpoint}")
    if args.oracle:
        if not hasattr(inferencer.model, "oracle_predict"):
            raise SystemExit(f"--oracle: '{cfg['model']['type']}' has no oracle_predict "
                             "(SAM-det has)")
        inferencer.oracle = True
    if args.tta:
        inferencer.tta = make_tta_predict(inferencer.model, **tta_settings(cfg))

    ds_cfg = dict((cfg.get("test_dataloader") or cfg["val_dataloader"])["dataset"])
    if args.corruption:
        ds_cfg["pipeline"] = [CorruptImage(args.corruption, args.severity)]
    dataset = DATASETS.build(ds_cfg)
    loader = DataLoader(dataset, batch_size=batch_size, prefetch=1,
                        shard_id=distributed.rank(), num_shards=world)
    classes = (dataset.metainfo or {}).get("classes")
    metric = CocoMetric(
        num_classes=cfg["model"].get("num_classes", 1), mask_mode=inferencer.mask_mode,
        dump_path=args.out, classwise=args.classwise, class_names=classes,
    )

    def show(metas, dets, probs) -> None:
        os.makedirs(args.show_dir, exist_ok=True)
        for i, meta in enumerate(metas):
            if meta.get("img_id", -1) != -1:
                draw_slot(os.path.join(args.show_dir, drawn_name(meta["img_path"])), dets,
                          probs, i, meta, classes, inferencer.mask_mode)

    report = evaluate(inferencer, loader, metric, visit=show if args.show_dir else None)
    results, timing, n_images = report["metrics"], report["timing"], report["timing"]["images"]
    if not main_rank:
        return dict(report, inferencer=inferencer)
    for k, v in results.items():
        print(f"{k}: {v}")
    print(f"{n_images} images in {timing['wall_s']:.3f} s "
          f"({n_images / timing['wall_s']:.3f} images/s) on {device}: decode + GT "
          f"{timing['load_s']:.3f} s (waiting on the loader), predict {timing['predict_s']:.3f} s, "
          f"metric.process {timing['process_s']:.3f} s, drawing {timing['visit_s']:.3f} s, "
          f"compute {timing['compute_s']:.3f} s")
    return dict(report, inferencer=inferencer)


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
