"""Train a detector from a config file.

    python -m rsprompter_tpu_torch.tools.train CONFIG [--work-dir D] [--resume] \\
        [--amp] [--cfg-options k=v ...] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/train.py`` (``main``
:39-213), for the detectors the port trains (``RSPrompterAnchor``,
``RSPrompterQuery``). The train set runs through the train pipeline
(``train_aug``, the default) or the deterministic test pipeline
(``train_aug=False``), batched by ``TrainLoader`` (shuffled per epoch,
``max_gt`` GT an image, padded to ``crop_size``, decoded two batches ahead
in a thread when ``num_workers > 0``); the val set is read raw, as
``tools.test`` reads it. The model is ``build_trainer``'s (seeded init, the
config's SAM file where it exists, a warning where it does not), with the
learning rate scaled by ``auto_scale_lr`` where enabled and
``warmup_cosine_schedule`` over ``max_epochs * len(train_loader)`` steps.
``Runner`` logs to ``WORK_DIR/metrics.jsonl`` (and the config's
``vis_backends``), saves ``WORK_DIR/ckpts/step_{n}`` and
``WORK_DIR/best_{bbox,segm}_mAP/step_{n}``, and with ``--resume`` continues
from the newest ``ckpts/step_{n}``; ``tools.test CONFIG
WORK_DIR/ckpts/step_{n}`` evaluates one.

Runs on the card unless ``--device cpu`` is given, on one device: a config
whose ``dist`` names more than one raises (ROADMAP A13). A config's
``vis_interval`` > 0 draws validation images into ``WORK_DIR/vis/``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.apis.inference import resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.loader import DataLoader, TrainLoader
from rsprompter_tpu_torch.data.transforms import build_test_pipeline, build_train_pipeline
from rsprompter_tpu_torch.engine.runner import Runner
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.engine.vis_backend import build_vis_backends


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--amp", action="store_true", help="bf16 compute")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="dotted config overrides: key=value")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def check_single_device(dist_cfg) -> None:
    dist_cfg = dict(dist_cfg or {})
    if dist_cfg.get("enable") or int(dist_cfg.get("model_parallel", 1)) > 1:
        raise NotImplementedError(
            f"dist={dist_cfg}: training across devices is not ported (ROADMAP A13)")


def check_num_classes(model_cfg, dataset) -> None:
    """The reference's NumClassCheckHook: the config's classes must match
    the dataset's."""
    n_cls = model_cfg.get("num_classes", 1)
    ds_cls = len(dataset.metainfo.get("classes", ()))
    if ds_cls and ds_cls != n_cls:
        raise ValueError(f"model.num_classes={n_cls} != dataset classes={ds_cls} "
                         f"({dataset.metainfo['classes']})")


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    """Train; returns the runner (its ``trainer`` holds the last state)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    if args.amp:
        cfg["model"]["bf16"] = True
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    check_single_device(cfg.get("dist"))
    seed = cfg.get("seed", 0)
    crop = tuple(cfg.get("crop_size", (1024, 1024)))
    max_gt = cfg.get("max_gt", 100)

    train_ds_cfg = dict(cfg["train_dataloader"]["dataset"])
    aug_rng = np.random.RandomState(seed)  # re-seeded each epoch by the loader
    # train_aug=False -> the deterministic resize / pad pipeline (overfit runs)
    train_ds_cfg["pipeline"] = (build_train_pipeline(crop, rng=aug_rng)
                                if cfg.get("train_aug", True) else build_test_pipeline(crop))
    train_ds = DATASETS.build(train_ds_cfg)
    check_num_classes(cfg["model"], train_ds)
    train_loader = TrainLoader(
        train_ds, batch_size=cfg["train_dataloader"].get("batch_size", 2), shuffle=True,
        max_gt=max_gt, pad_shape=crop, rng=aug_rng,
        prefetch=2 if cfg["train_dataloader"].get("num_workers", 0) > 0 else 0,
    )
    val_loader = None
    if cfg.get("val_dataloader"):
        val_ds = DATASETS.build(dict(cfg["val_dataloader"]["dataset"]))
        val_loader = DataLoader(val_ds, batch_size=cfg["val_dataloader"].get("batch_size", 2),
                                prefetch=1)

    # reference auto_scale_lr: linear scaling by the batch size
    asl = cfg.get("auto_scale_lr") or {}
    if asl.get("enable"):
        bs = cfg["train_dataloader"].get("batch_size", 2)
        cfg["base_lr"] = cfg.get("base_lr", 1e-4) * bs / asl.get("base_batch_size", bs)
        print(f"auto_scale_lr: lr -> {cfg['base_lr']}")

    # the schedule (warm-up cosine over max_epochs * len(train_loader)) and
    # the freeze rules (freeze_paths_for) are the trainer's
    trainer = build_trainer(cfg, device=device, seed=seed,
                            steps_per_epoch=max(len(train_loader), 1))
    runner = Runner(
        trainer, train_loader, val_loader,
        work_dir=work_dir,
        max_epochs=cfg.get("max_epochs", 12),
        val_interval=cfg.get("val_interval", 3),
        ckpt_interval=cfg.get("ckpt_interval", 1),
        log_interval=cfg.get("log_interval", 20),
        num_classes=cfg["model"].get("num_classes", 1),
        lr_schedule=trainer.optimizer.schedule,
        vis_backends=build_vis_backends(cfg.get("vis_backends"), work_dir),
        vis_interval=cfg.get("vis_interval", 0),
    )
    runner.train(resume=args.resume)
    return runner


if __name__ == "__main__":
    main()
