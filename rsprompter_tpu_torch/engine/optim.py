"""Optimizer: global-norm clip, then AdamW with warm-up plus cosine, on the
parameters that train.

Counterpart of ``rsprompter_tpu/engine/optim.py``. JAX labels each parameter
'train' or 'frozen' (``build_param_label_fn`` :38: frozen when a freeze path
is a substring of its name) and sends the frozen ones through
``optax.set_to_zero``; here the label picks the parameter group (JAX's
override paths serve LoRA, which is not ported):
frozen parameters take no update and no weight decay, and keep their
``requires_grad``, so gradients still flow through them to what trains (and
still count in the step's ``grad_norm``, as JAX's do). The trained group gets
what ``optax.chain(clip_by_global_norm(c), adamw(schedule, 0.9, 0.999,
weight_decay=wd))`` does: the clip over the trained gradients only, Adam's
bias-corrected moments with eps 1e-8 outside the square root, the decay
added to the update before the learning rate scales it (``torch.optim.AdamW``
computes the same update), and the schedule read at the step count before
the update, as optax reads it.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

Schedule = Callable[[int], float]


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 50,
                           warmup_start_factor: float = 0.001,
                           eta_min_factor: float = 0.001) -> Schedule:
    """Linear warm-up from ``base_lr * warmup_start_factor`` over
    ``warmup_steps``, then cosine to ``base_lr * eta_min_factor`` (optax's
    ``join_schedules`` of a linear and a cosine-decay schedule)."""
    init = base_lr * warmup_start_factor
    ramp = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init + (base_lr - init) * min(step, ramp) / ramp
        t = min(step - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return base_lr * ((1.0 - eta_min_factor) * cosine + eta_min_factor)

    return schedule


class Optimizer:
    """One update per :meth:`step` from the parameters' ``.grad``."""

    def __init__(self, model: nn.Module, schedule: Schedule, weight_decay: float,
                 freeze_paths: Sequence[str] = (), grad_clip: Optional[float] = None):
        self.model = model
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.trained: List[Tuple[str, nn.Parameter]] = []
        self.frozen: List[Tuple[str, nn.Parameter]] = []
        for name, p in model.named_parameters():
            frozen = any(f in name for f in freeze_paths)
            (self.frozen if frozen else self.trained).append((name, p))
        params = [p for _, p in self.trained]
        self.adamw = torch.optim.AdamW(
            params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.count = 0
        self.lr = schedule(0)  # the learning rate of the last update
        self.unreached: List[str] = []  # trained parameters the last loss did not reach

    def zero_grad(self) -> None:
        self.model.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, then AdamW. Returns the global norm of every parameter's
        gradient before the clip, frozen ones included (JAX's ``grad_norm``);
        the clip uses the norm over the trained ones. A trained parameter the
        loss did not reach gets a zero gradient, as in JAX: its moments decay
        and its weight decay still applies."""
        grads = []
        self.unreached = []
        for name, p in self.trained:
            if p.grad is None:
                self.unreached.append(name)
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        frozen = [p.grad for _, p in self.frozen if p.grad is not None]
        # one pass over every gradient; fp64 norms, as the CPU's fp32 norm
        # accumulates long tensors in order and drifts by ~1e-3
        sq = torch.stack(torch._foreach_norm(grads + frozen, 2, dtype=torch.float64)).square()
        trained_sq = sq[: len(grads)].sum()
        if self.grad_clip:
            norm = trained_sq.sqrt()
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, scale.float())
        self.lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr
        self.adamw.step()
        self.count += 1
        return (trained_sq + sq[len(grads):].sum()).sqrt().float()


def build_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                    total_steps: int = 10000, warmup_steps: int = 50,
                    freeze_paths: Sequence[str] = (),
                    grad_clip: Optional[float] = None,
                    schedule: Optional[Schedule] = None) -> Optimizer:
    """AdamW + warm-up cosine over the parameters that train (JAX's
    ``build_optimizer`` :86, without gradient accumulation)."""
    sched = schedule or warmup_cosine_schedule(base_lr, total_steps, warmup_steps)
    return Optimizer(model, sched, weight_decay, freeze_paths, grad_clip)
