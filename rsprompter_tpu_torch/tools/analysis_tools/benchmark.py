"""Inference, data loader or dataset throughput.

    python -m rsprompter_tpu_torch.tools.analysis_tools.benchmark CONFIG \\
        [--task inference|dataloader|dataset] [--repeat 20] [--batch-size 1] \\
        [--device cuda|cpu]

The port's counterpart of the JAX package's
``tools/analysis_tools/benchmark.py`` (the reference's
``mmdet/utils/benchmark.py``):

- ``inference``: the config's detector (seeded weights, bf16 where the
  config says so) predicts ``utils.testing.demo_batch``'s random non-zero
  batch at the config's ``crop_size``; after three warm-up calls,
  ``--repeat`` calls are timed, on the card between two CUDA events, on the
  CPU by the host's clock. Prints images/s and ms a batch, with the card's
  name and power limit as ``nvidia-smi`` gives them (a card may run below
  its 700 W maximum, and slower).
- ``dataloader``: the train set through the port's train pipeline and
  ``TrainLoader``, batches of ``train_dataloader.batch_size``.
- ``dataset``: ``load_raw`` (decode and annotations) of the train set.

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Any, Dict, Optional, Sequence

import torch

from rsprompter_tpu_torch.apis.inference import init_detector, resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.loader import TrainLoader
from rsprompter_tpu_torch.data.transforms import build_train_pipeline
from rsprompter_tpu_torch.utils.testing import demo_batch

WARMUP = 3


def card_label() -> str:
    """``name, power limit`` of the first card, as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"nvidia-smi failed ({out.returncode})"


def bench_inference(cfg, repeat: int, batch_size: int, device: torch.device) -> Dict[str, Any]:
    crop = tuple(cfg.get("crop_size", (1024, 1024)))
    model = init_detector(cfg, device=device, batch_size=batch_size).model
    demo = demo_batch(batch_size, crop, max_gt=8, device=device)
    batch = {k: demo[k] for k in ("images", "img_shape")}
    for _ in range(WARMUP):
        model.predict(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            model.predict(batch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / repeat
        where = card_label()
    else:
        t0 = time.perf_counter()
        for _ in range(repeat):
            model.predict(batch)
        ms = (time.perf_counter() - t0) * 1e3 / repeat
        where = "cpu"
    fps = batch_size * 1e3 / ms
    print(f"inference: {fps:.2f} img/s ({ms:.1f} ms/batch of {batch_size}) on {where}")
    return dict(images_per_s=fps, ms_per_batch=ms, device=where)


def bench_dataloader(cfg, repeat: int) -> Dict[str, Any]:
    crop = tuple(cfg.get("crop_size", (1024, 1024)))
    ds_cfg = dict(cfg["train_dataloader"]["dataset"])
    ds_cfg["pipeline"] = build_train_pipeline(crop)
    ds = DATASETS.build(ds_cfg)
    loader = TrainLoader(ds, batch_size=cfg["train_dataloader"].get("batch_size", 2),
                         pad_shape=crop)
    n = 0
    t0 = time.perf_counter()
    for _batch, metas in loader:
        n += len(metas)
        if n >= repeat:
            break
    rate = n / (time.perf_counter() - t0)
    print(f"dataloader: {rate:.2f} img/s")
    return dict(images_per_s=rate)


def bench_dataset(cfg, repeat: int) -> Dict[str, Any]:
    ds_cfg = dict(cfg["train_dataloader"]["dataset"])
    ds_cfg["pipeline"] = []
    ds = DATASETS.build(ds_cfg)
    n = min(repeat, len(ds))
    t0 = time.perf_counter()
    for i in range(n):
        ds.load_raw(i)
    rate = n / (time.perf_counter() - t0)
    print(f"dataset decode: {rate:.2f} img/s")
    return dict(images_per_s=rate)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description="inference / data loader / dataset throughput")
    p.add_argument("config")
    p.add_argument("--task", default="inference", choices=["inference", "dataloader", "dataset"])
    p.add_argument("--repeat", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    if args.task == "inference":
        return bench_inference(cfg, args.repeat, args.batch_size, resolve_device(args.device))
    if args.task == "dataloader":
        return bench_dataloader(cfg, args.repeat)
    return bench_dataset(cfg, args.repeat)


if __name__ == "__main__":
    main()
