"""The train step: forward, every loss, backward, clip and AdamW.

Counterpart of ``rsprompter_tpu/engine/train_state.py`` (``total_loss`` :45,
``make_train_step`` :49). JAX compiles the whole step into one program over a
functional state; here the step is eager over the module's own parameters
(updated in place) and BatchNorm statistics (updated by the forward in train
mode), and the optimizer keeps its moments. ``build_trainer`` is the entry
point: it builds the detector from a config on the card, unless the caller
asks for the CPU, with seeded random weights (checkpoints come with the
runner, not ported yet) and fp32 master parameters computing in bf16 where
the config says ``bf16=True``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from rsprompter_tpu_torch.apis.build import (
    build_detector,
    freeze_paths_for,
    init_random_weights,
    set_compute_dtype,
)
from rsprompter_tpu_torch.apis.inference import resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.engine.optim import Optimizer, build_optimizer


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(v for k, v in losses.items() if k.startswith("loss"))


def make_train_step(model: nn.Module, optimizer: Optimizer) -> Callable:
    """Returns step(batch, generator=None) -> metrics: every loss term,
    ``acc``, ``loss`` (their sum) and ``grad_norm`` (the global norm of every
    parameter's gradient before the clip, frozen ones included), as device
    tensors. One optimizer update per call; the samplers draw from
    ``generator``."""

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        losses = model.loss(batch, generator=generator)
        loss = total_loss(losses)
        loss.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step


class Trainer:
    """A detector, its optimizer and its train step, built from a config;
    the schedule spans ``max_epochs * steps_per_epoch`` steps, as JAX's
    ``tools/train.py`` sets it."""

    def __init__(self, config: Union[str, Dict[str, Any], Config],
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 steps_per_epoch: int = 1):
        self.device = resolve_device(device)
        if isinstance(config, (str, os.PathLike)):
            cfg = Config.fromfile(config)
        elif isinstance(config, Config):
            cfg = config
        else:
            cfg = Config.fromdict(config)
        self.cfg = cfg
        model_cfg = cfg["model"]
        self.model = build_detector(model_cfg)
        init_random_weights(self.model, seed)  # checkpoints come with the runner
        if model_cfg.get("bf16", False):
            set_compute_dtype(self.model, torch.bfloat16, cast_params=False)
        self.model.to(self.device).train()
        self.optimizer = build_optimizer(
            self.model, base_lr=cfg.get("base_lr", 1e-4),
            weight_decay=cfg.get("weight_decay", 0.05),
            total_steps=cfg.get("max_epochs", 12) * steps_per_epoch,
            warmup_steps=cfg.get("warmup_iters", 50),
            freeze_paths=freeze_paths_for(model_cfg), grad_clip=cfg.get("grad_clip"),
        )
        self.step = make_train_step(self.model, self.optimizer)


def build_trainer(config, device: Union[str, torch.device] = "cuda", **kwargs) -> Trainer:
    """Build a trainer on the card (``device='cpu'`` for the plain versions;
    raises without a GPU otherwise)."""
    return Trainer(config, device=device, **kwargs)
