"""The train step: forward, every loss, backward, clip and AdamW.

Counterpart of ``rsprompter_tpu/engine/train_state.py`` (``total_loss`` :45,
``make_train_step`` :49). JAX compiles the whole step into one program over a
functional state; here the step is eager over the module's own parameters
(updated in place) and BatchNorm statistics (updated by the forward in train
mode), and the optimizer keeps its moments. ``build_trainer`` is the entry
point: it builds the detector (any of the five families) from a config
on the card, unless the caller asks for the CPU, with seeded random
weights, the SAM subtrees from the config's ``hf_sam_pretrain_ckpt_path``
where that file exists (``engine/checkpoint.py``), and fp32 master
parameters computing in bf16 where the config says ``bf16=True``.
:meth:`Trainer.train_step` is the step the runner takes: it seeds the
samplers' generator from ``(seed, iter)``, as JAX folds ``state.step`` into
its key (:60), so a resumed run draws what an uninterrupted one would;
:meth:`Trainer.state_dict` is what a train checkpoint holds.

Data parallelism (JAX's ``make_sharded_train_step``, :117-150): in a process
group of more than one rank (``parallel.distributed.initialize``, one rank
per GPU under torchrun) the trainer wraps the model in
``DistributedDataParallel`` (:func:`data_parallel`) and the step calls it
with ``mode='loss'``; at world 1 there is nothing to synchronise and the
step calls the detector itself. Each rank takes ``b`` images; the samplers keep their rows
of the global batch's draws, the loss normalisers count the global batch
and BatchNorm sums over the ranks, so DDP's mean gradient, ``grad_norm``,
the update and the statistics are those of one process on the ranks'
batches concatenated in rank order. The metrics are averaged over the
ranks, which makes the logged losses the global batch's. The config's
``dist`` (``parallel.mesh.mesh_from_config``) picks ZeRO (default on).
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
from rsprompter_tpu_torch.engine.checkpoint import load_config_sam
from rsprompter_tpu_torch.engine.optim import Optimizer, build_optimizer
from rsprompter_tpu_torch.parallel.distributed import all_reduce_mean, world_size
from rsprompter_tpu_torch.parallel.mesh import mesh_from_config


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of the terms whose name starts with ``loss``, as JAX's
    ``total_loss`` (:45): for the query head only the last of its seven
    calls, its ``d0.`` ... ``d5.`` terms are reported and do not train."""
    return sum(v for k, v in losses.items() if k.startswith("loss"))


def make_train_step(model: nn.Module, optimizer: Optimizer) -> Callable:
    """Returns step(batch, generator=None) -> metrics: every loss term,
    ``acc``, ``loss`` (:func:`total_loss`) and ``grad_norm`` (the global norm of every
    parameter's gradient before the clip, frozen ones included), as device
    tensors, each the mean over the ranks in a process group. One optimizer
    update per call; ``model`` (a detector, or its DDP wrapper) is called with
    ``mode='loss'``, the samplers drawing from ``generator``, or taking
    ``draws`` (the detector's ``loss`` says their shapes, for the global
    batch)."""

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        losses = model(batch, mode="loss", generator=generator, draws=draws)
        loss = total_loss(losses)
        loss.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = optimizer.step()
        if world_size() > 1:  # one collective for every metric
            names = list(metrics)
            means = all_reduce_mean(torch.stack([metrics[k].float() for k in names]))
            metrics = dict(zip(names, means.unbind()))
        return metrics

    return step


def data_parallel(model: nn.Module) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` over the process group, with
    no buffer broadcast (BatchNorm's statistics are the global batch's on
    every rank already). Parameters the loss does not reach (a frozen
    encoder, SAM-det's segmentor, the anchor family's IoU head) are found by
    a walk of the autograd graph every step (``find_unused_parameters``).
    ``static_graph``, which finds them once, read 1.9% and 6.7% a step
    faster in two runs at world 1 on an H100 (``chip_smoke.py`` phase 19),
    where DDP's overhead itself spread from 1.06x to 1.21x; it would leave
    a parameter first reached after the first step unsynchronised."""
    return nn.parallel.DistributedDataParallel(model, broadcast_buffers=False,
                                               find_unused_parameters=True)


def step_seed(seed: int, step: int) -> int:
    """The samplers' seed at ``step`` of a run seeded ``seed`` (distinct for
    every pair below 2^32 steps)."""
    return (seed << 32) + step


class Trainer:
    """A detector, its optimizer and its train step, built from a config;
    the schedule spans ``max_epochs * steps_per_epoch`` steps, as JAX's
    ``tools/train.py`` sets it (``steps_per_epoch`` is the train loader's
    length). In a process group of more than one rank the model is wrapped
    in ``DistributedDataParallel`` (``ddp``); ``model`` stays the detector."""

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
        init_random_weights(self.model, seed)
        load_config_sam(self.model, model_cfg)  # where the config's file exists
        if model_cfg.get("bf16", False):
            set_compute_dtype(self.model, torch.bfloat16, cast_params=False)
        self.model.to(self.device).train()
        _, zero = mesh_from_config(cfg.get("dist"))
        self.ddp = data_parallel(self.model) if world_size() > 1 else None
        freeze, override = freeze_paths_for(model_cfg)
        self.optimizer = build_optimizer(
            self.model, base_lr=cfg.get("base_lr", 1e-4),
            weight_decay=cfg.get("weight_decay", 0.05),
            total_steps=cfg.get("max_epochs", 12) * steps_per_epoch,
            warmup_steps=cfg.get("warmup_iters", 50),
            freeze_paths=freeze, train_paths_override=override,
            grad_clip=cfg.get("grad_clip"), zero=zero and world_size() > 1,
        )
        self.step = make_train_step(self.ddp or self.model, self.optimizer)
        self.seed = seed
        self.iter = 0  # steps taken (JAX's ``state.step``)
        self.generator = torch.Generator(device=self.device)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on a batch on the device, the samplers drawing from a
        generator seeded from ``(seed, iter)``; returns the step's metrics
        as device tensors."""
        self.generator.manual_seed(step_seed(self.seed, self.iter))
        metrics = self.step(batch, self.generator)
        self.iter += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """The model's state_dict (fp32 master parameters and BN buffers),
        the optimizer's (AdamW's moments and step, its update count, the
        accumulation state) and the step. Under ZeRO a collective that every
        rank calls (only rank 0's holds the moments)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.iter}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iter = int(state["step"])


def build_trainer(config, device: Union[str, torch.device] = "cuda", **kwargs) -> Trainer:
    """Build a trainer on the card (``device='cpu'`` for the plain versions;
    raises without a GPU otherwise)."""
    return Trainer(config, device=device, **kwargs)
