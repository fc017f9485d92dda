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

Runs on the card unless ``--device cpu`` is given. Data parallel on N
GPUs of one host, one process each (JAX :60-128, :188-205):

    python -m torch.distributed.run --nproc_per_node N \
        -m rsprompter_tpu_torch.tools.train CONFIG [...]

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``), takes the config's ``batch_size`` images a step (per device, as
in the reference and JAX) from its shard of the train set
(``TrainLoader(shard_id=rank, num_shards=world)``), and validates its block
of the val set; ``auto_scale_lr`` scales by the global batch (``batch_size
* world``, JAX :161-166) and the schedule counts the sharded loader's
steps. The config's ``dist``: ``zero`` (shard AdamW's moments, default
True), ``enable`` (True without the launcher raises and says how to launch;
False under a launcher of more than one process raises),
``model_parallel`` (only 1: TP is not ported). A config's
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
from rsprompter_tpu_torch.parallel import distributed
from rsprompter_tpu_torch.parallel.mesh import mesh_from_config


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
    device = distributed.initialize(resolve_device(args.device))
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    if args.amp:
        cfg["model"]["bf16"] = True
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    world, zero = mesh_from_config(cfg.get("dist"))
    rank = distributed.rank()
    if world > 1 and distributed.is_main():
        print(f"data parallel: {world} ranks (zero={zero}), {distributed.process_info()}")
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
    bs = cfg["train_dataloader"].get("batch_size", 2)  # per device
    train_loader = TrainLoader(
        train_ds, batch_size=bs, shuffle=True, max_gt=max_gt, pad_shape=crop, rng=aug_rng,
        prefetch=2 if cfg["train_dataloader"].get("num_workers", 0) > 0 else 0,
        shard_id=rank, num_shards=world,
    )
    val_loader = None
    if cfg.get("val_dataloader"):
        val_ds = DATASETS.build(dict(cfg["val_dataloader"]["dataset"]))
        val_loader = DataLoader(val_ds, batch_size=cfg["val_dataloader"].get("batch_size", 2),
                                prefetch=1, shard_id=rank, num_shards=world)

    # reference auto_scale_lr: linear scaling by the global batch size
    asl = cfg.get("auto_scale_lr") or {}
    if asl.get("enable"):
        global_bs = bs * world
        cfg["base_lr"] = (cfg.get("base_lr", 1e-4) * global_bs
                          / asl.get("base_batch_size", global_bs))
        if distributed.is_main():
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
    try:
        main()
    finally:
        distributed.shutdown()
