"""The train loop around the step: epochs, logging, checkpoints, validation.

Counterpart of ``rsprompter_tpu/engine/runner.py`` (``Runner.train`` :122,
``validate`` :257), the thin replacement of mmengine's EpochBasedTrainLoop,
ValLoop and hooks: per-iteration logging with it/s, the learning rate and the
host's RSS; a finite-loss guard; a checkpoint every ``ckpt_interval`` epochs
and at the last; validation every ``val_interval`` epochs with the best
checkpoint kept for each ``save_best`` key; resume from the newest
checkpoint, with the loader's epoch realigned to the restored step.

The step runs on :class:`~rsprompter_tpu_torch.engine.train_state.Trainer`.
Its metrics stay on the device: the host reads them only at log points, in
one copy (JAX's sync at log points, :164-177), so the guard fires within
``log_interval`` steps of a non-finite loss and the runner adds no wait of its
own to a step. Batches go up from pinned memory without a wait
(``non_blocking``); their masks are unpacked on the device.

Validation runs the trainer's own module, in eval mode and without
gradients, through the loop ``tools.test`` runs (``evaluation.loop``), and
adds JAX's digest keys ``val/num_dets``, ``val/mean_score`` and
``val/mean_mask_prob``. With ``vis_interval`` > 0 the first image of every
batch that starts at an image offset divisible by it (padded slots counted,
as JAX counts them) is drawn into ``WORK_DIR/vis/val_{offset}.jpg``
(JAX's ``_visualize``, :292-331: detections over a score of 0.3 over the
original file). As in JAX a drawing that fails does not stop training: what
reading, drawing and writing the file raise (``OSError``, ``ValueError``)
is logged; anything else, a CUDA error among it, propagates.

In a process group (``tools.train`` under torchrun; JAX's mesh, :213-250)
every rank runs the loop on its shard of the train loader, the trainer's
metrics already the global batch's; validation runs sharded (each rank's
val loader one block, ``evaluation.loop``), and every rank gets rank 0's
metrics, so all take the same checkpoint branches. Rank 0 alone logs and
writes checkpoints (every rank calls the save, a collective under ZeRO);
each rank draws its own validation images, named by their offset in the
whole set. Not ported: JAX's ``batch_fn`` and ``cache_train_batches``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rsprompter_tpu_torch.apis.inference import DetInferencer
from rsprompter_tpu_torch.apis.visualization import draw_slot
from rsprompter_tpu_torch.engine.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from rsprompter_tpu_torch.engine.vis_backend import LocalVisBackend
from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric
from rsprompter_tpu_torch.evaluation.loop import evaluate
from rsprompter_tpu_torch.ops.masks import unpack_batch_masks
from rsprompter_tpu_torch.parallel.distributed import is_main


def _host_rss_mb() -> float:
    """Resident set size in MB (psutil-free: /proc/self/statm)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return round(pages * os.sysconf("SC_PAGE_SIZE") / 1e6, 1)
    except (OSError, ValueError):
        return -1.0


def upload(batch: Dict[str, np.ndarray], device: torch.device,
           pin: bool = True) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> the train step's batch on ``device``: on the
    card each array goes through pinned memory with a non-blocking copy
    (``pin=False``: a pageable copy, which waits for the device), labels
    become int64, ``gt_masks_packed`` is unpacked there."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda" and pin:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    out["gt_labels"] = out["gt_labels"].long()
    return unpack_batch_masks(out)


class Runner:
    def __init__(
        self,
        trainer,
        train_loader,
        val_loader=None,
        work_dir: str = "./work_dir",
        max_epochs: int = 12,
        val_interval: int = 3,
        ckpt_interval: int = 1,
        log_interval: int = 20,
        num_classes: int = 1,
        lr_schedule=None,
        vis_backends: Optional[Sequence] = None,
        save_best: Sequence[str] = ("coco/bbox_mAP", "coco/segm_mAP"),
        vis_interval: int = 0,
    ):
        self.trainer = trainer
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.work_dir = work_dir
        self.max_epochs = max_epochs
        self.val_interval = val_interval
        self.ckpt_interval = ckpt_interval
        self.log_interval = log_interval
        self.num_classes = num_classes
        self.lr_schedule = lr_schedule
        os.makedirs(work_dir, exist_ok=True)
        self.vis_backends = list(vis_backends) if vis_backends else [LocalVisBackend(work_dir)]
        self.save_best = tuple(save_best)
        self.vis_interval = vis_interval
        self.best_metrics = {k: -1.0 for k in self.save_best}
        self.save_ms: List[float] = []  # the host time of each checkpoint save
        self._last_log = (time.perf_counter(), 0)

    def _log(self, record: Dict[str, Any]) -> None:
        if not is_main():
            return
        record = {k: (float(v) if isinstance(v, (np.floating, np.ndarray)) else v)
                  for k, v in record.items()}
        for backend in self.vis_backends:
            backend.log_scalars(record, step=record.get("iter"))
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items()), flush=True)

    def _save(self, ckpt_dir: str, keep: int = 5) -> str:
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, self.trainer, self.trainer.iter, keep=keep)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        return path

    def train(self, resume: bool = False):
        ckpt_dir = os.path.join(self.work_dir, "ckpts")
        spe = max(len(self.train_loader), 1)
        if resume:
            path = latest_checkpoint(ckpt_dir)
            if path:
                restore_checkpoint(path, self.trainer)
                # the epoch-seeded shuffle (and augmentation) realigned
                # with the restored step, as the unresumed run would see it
                self.train_loader.epoch = self.trainer.iter // spe
                if is_main():
                    print(f"resumed from {path}")
        start_epoch = min(self.trainer.iter // spe, self.max_epochs)
        self._last_log = (time.perf_counter(), self.trainer.iter)
        for epoch in range(start_epoch, self.max_epochs):
            self.train_epoch(epoch)
            if (epoch + 1) % self.ckpt_interval == 0 or epoch == self.max_epochs - 1:
                self._save(ckpt_dir)
            if self.val_loader is not None and (epoch + 1) % self.val_interval == 0:
                results = self.validate()
                self._log(dict(epoch=epoch, **results))
                # dual-key best checkpointing (reference save_best on both, rule greater)
                for key in self.save_best:
                    val = results.get(key)
                    if val is not None and val > self.best_metrics[key]:
                        self.best_metrics[key] = val
                        tag = key.split("/")[-1]
                        self._save(os.path.join(self.work_dir, f"best_{tag}"), keep=1)
        return self.trainer

    def train_epoch(self, epoch: int) -> None:
        """One pass over the train loader, logging every ``log_interval`` steps."""
        device = self.trainer.device
        for batch_np, _metas in self.train_loader:
            metrics = self.trainer.train_step(upload(batch_np, device))
            it = self.trainer.iter
            if it % self.log_interval:
                continue
            names = list(metrics)
            values = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
            rec: Dict[str, Any] = dict(epoch=epoch, iter=it)
            rec.update(zip(names, values.tolist()))  # the host's one wait
            if not math.isfinite(rec["loss"]):
                raise FloatingPointError(f"non-finite loss at iter {it}: {rec}")
            now = time.perf_counter()
            last_t, last_it = self._last_log
            rec["it_per_s"] = (it - last_it) / max(now - last_t, 1e-9)
            if self.lr_schedule is not None:
                rec["lr"] = float(self.lr_schedule(it))
            rec["rss_mb"] = _host_rss_mb()
            self._last_log = (now, it)
            self._log(rec)

    def validate(self) -> Dict[str, float]:
        """COCO metrics and the digest of the trainer's module on the val loader."""
        model = self.trainer.model
        inferencer = DetInferencer.from_module(model, self.trainer.cfg,
                                               batch_size=self.val_loader.batch_size)
        metric = CocoMetric(num_classes=self.num_classes, mask_mode=inferencer.mask_mode)
        offset = getattr(self.val_loader, "start", 0)  # the shard's place in the set

        def visualize(metas, dets, probs) -> None:
            nonlocal offset
            if offset % self.vis_interval == 0:
                self._visualize(metas[0], dets, probs, offset, inferencer.mask_mode)
            offset += len(metas)

        model.eval()
        try:
            with torch.no_grad():
                report = evaluate(inferencer, self.val_loader, metric,
                                  visit=visualize if self.vis_interval else None)
        finally:
            model.train()
        return dict(report["metrics"], **report["digest"])

    def _visualize(self, meta, dets, probs, index: int, mask_mode: str) -> None:
        """Draw slot 0 of a validation batch into ``vis/val_{index}.jpg``."""
        classes = (getattr(self.val_loader.dataset, "metainfo", None) or {}).get("classes")
        try:
            vis_dir = os.path.join(self.work_dir, "vis")
            os.makedirs(vis_dir, exist_ok=True)
            draw_slot(os.path.join(vis_dir, f"val_{index}.jpg"), dets, probs, 0, meta,
                      classes, mask_mode)
        except (OSError, ValueError) as err:  # a drawing never stops training
            print(f"vis failed: {err}", flush=True)
