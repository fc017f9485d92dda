"""Optimizer: global-norm clip, then AdamW with warm-up plus cosine, on the
parameters that train.

Counterpart of ``rsprompter_tpu/engine/optim.py``. JAX labels each parameter
'train' or 'frozen' (``build_param_label_fn`` :38: trained when an override
path is a substring of its name, checked first, as at :54; else frozen when
a freeze path is; the peft configs freeze ``backbone`` and override it with
``lora_a`` / ``lora_b``, so the encoder's LoRA adapters train inside it) and
sends the frozen ones through ``optax.set_to_zero``; here the label picks
the parameter group:
frozen parameters take no update and no weight decay, and keep their
``requires_grad``, so gradients still flow through them to what trains (and
still count in the step's ``grad_norm``, as JAX's do). The trained group gets
what ``optax.chain(clip_by_global_norm(c), adamw(schedule, 0.9, 0.999,
weight_decay=wd))`` does: the clip over the trained gradients only, Adam's
bias-corrected moments with eps 1e-8 outside the square root, the decay
added to the update before the learning rate scales it (``torch.optim.AdamW``
computes the same update), and the schedule read at the step count before
the update, as optax reads it.

``accumulate_steps`` k > 1 is ``optax.MultiSteps(tx, every_k_schedule=k)``
(JAX :119): each micro-step folds its gradients into a running mean
(Welford's update, as optax's), and only the k-th clips, updates and
advances the schedule's count; the parameters stay as they are on the
others.

With ``zero`` (a process group of more than one rank; the config's
``dist.zero``, default True), AdamW's moments are sharded over the ranks
by ``torch.distributed.optim.ZeroRedundancyOptimizer``, JAX's
``zero_shardings`` (``parallel/mesh.py:84-101``): each rank updates its
share of the parameters and broadcasts them. The gradients it reads are
DDP's means, the same on every rank, so the clip's norm is the global
one. :meth:`Optimizer.state_dict` is then a collective that every rank
calls; rank 0 gets the whole state, in the layout of one
``torch.optim.AdamW``'s ``state_dict``, so a checkpoint resumes at any
world size.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.parallel.distributed import all_gather_object, is_main

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
                 freeze_paths: Sequence[str] = (), grad_clip: Optional[float] = None,
                 accumulate_steps: int = 1, train_paths_override: Sequence[str] = (),
                 zero: bool = False):
        self.model = model
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.trained: List[Tuple[str, nn.Parameter]] = []
        self.frozen: List[Tuple[str, nn.Parameter]] = []
        for name, p in model.named_parameters():
            frozen = (not any(t in name for t in train_paths_override)
                      and any(f in name for f in freeze_paths))
            (self.frozen if frozen else self.trained).append((name, p))
        params = [p for _, p in self.trained]
        hyper = dict(lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.zero = zero
        if zero:  # imported here: the module costs seconds to import
            from torch.distributed.optim import ZeroRedundancyOptimizer

            self.adamw = ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.AdamW,
                                                 **hyper)
        else:
            self.adamw = torch.optim.AdamW(params, **hyper)
        self.count = 0  # updates made (the schedule's count)
        self.accumulate_steps = accumulate_steps
        self.mini_step = 0  # micro-steps folded into ``acc_grads`` since the last update
        self.acc_grads: List[torch.Tensor] = []
        self.lr = schedule(0)  # the learning rate of the last update
        self.unreached: List[str] = []  # trained parameters the last loss did not reach

    def zero_grad(self) -> None:
        self.model.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, then AdamW (on the k-th micro-step only, with the mean of
        the k gradients, where ``accumulate_steps`` is k). Returns the global
        norm of every parameter's gradient before the clip, frozen ones
        included (JAX's ``grad_norm``, of this micro-step's gradients); the
        clip uses the norm over the trained ones. A trained parameter the
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
        grad_norm = (trained_sq + sq[len(grads):].sum()).sqrt().float()
        if self.accumulate_steps > 1:
            if self.mini_step == 0:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            # acc + (g - acc) / (n + 1): optax's running mean
            diff = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc_grads, diff)
            self.mini_step += 1
            if self.mini_step < self.accumulate_steps:
                return grad_norm
            self.mini_step = 0
            for (_, p), acc in zip(self.trained, self.acc_grads):
                p.grad = acc
            grads, self.acc_grads = list(self.acc_grads), []
            trained_sq = torch.stack(
                torch._foreach_norm(grads, 2, dtype=torch.float64)).square().sum()
        if self.grad_clip:
            norm = trained_sq.sqrt()
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, scale.float())
        self.lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr
        self.adamw.step()
        self.count += 1
        return grad_norm

    def state_dict(self) -> Dict[str, Any]:
        """AdamW's moments and step, the update count and the accumulation
        state: everything :meth:`step` reads besides the parameters. Under
        ZeRO a collective: every rank calls it, and only rank 0's holds the
        moments (``adamw`` is None on the others)."""
        if self.zero:
            adamw = self._gather_zero_state()
            adamw = adamw if is_main() else None
        else:
            adamw = self.adamw.state_dict()
        return {"adamw": adamw, "count": self.count,
                "mini_step": self.mini_step, "acc_grads": list(self.acc_grads)}

    def _gather_zero_state(self) -> Dict[str, Any]:
        """Every rank's shard of the moments, each tensor broadcast from its
        owner (``ZeroRedundancyOptimizer.consolidate_state_dict`` sends each
        shard as one pickle through a Python-built byte tensor: minutes at
        ViT-B), in the layout of one ``torch.optim.AdamW``'s state_dict, on
        the CPU."""
        local = self.adamw.optim.state  # this rank's shard, by parameter
        owned = all_gather_object([i for i, (_, p) in enumerate(self.trained) if p in local])
        owner = {i: r for r, indices in enumerate(owned) for i in indices}
        state = {}
        for i, (_, p) in enumerate(self.trained):
            if i not in owner:  # no update has reached it yet
                continue
            mine = local.get(p)
            tensors = ([mine["step"].float().reshape(1).to(p.device), mine["exp_avg"],
                        mine["exp_avg_sq"]] if mine else
                       [torch.zeros(1, device=p.device), torch.empty_like(p),
                        torch.empty_like(p)])
            for t in tensors:
                torch.distributed.broadcast(t, src=owner[i])
            step, avg, sq = (t.cpu() for t in tensors)
            state[i] = {"step": step.reshape(()), "exp_avg": avg, "exp_avg_sq": sq}
        groups = [dict({k: v for k, v in g.items() if k != "params"},
                       params=list(range(len(self.trained))))
                  for g in self.adamw.param_groups]
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` written at any world size, with or
        without ZeRO: the moments by parameter index, the hyperparameters
        this optimizer's own (the learning rate follows the schedule)."""
        saved = state["adamw"]
        groups = [dict({k: v for k, v in own.items() if k != "params"}, params=g["params"])
                  for own, g in zip(self.adamw.param_groups, saved["param_groups"])]
        self.adamw.load_state_dict({"state": dict(saved["state"]), "param_groups": groups})
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc_grads = [a.to(p.device) for a, (_, p) in zip(state["acc_grads"], self.trained)]
        self.lr = self.schedule(max(self.count - 1, 0))


def build_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                    total_steps: int = 10000, warmup_steps: int = 50,
                    freeze_paths: Sequence[str] = (),
                    grad_clip: Optional[float] = None,
                    schedule: Optional[Schedule] = None,
                    accumulate_steps: int = 1,
                    train_paths_override: Sequence[str] = (),
                    zero: bool = False) -> Optimizer:
    """AdamW + warm-up cosine over the parameters that train, with gradients
    averaged over ``accumulate_steps`` micro-steps (JAX's ``build_optimizer``
    :86); with ``zero``, its moments sharded over the process group."""
    sched = schedule or warmup_cosine_schedule(base_lr, total_steps, warmup_steps)
    return Optimizer(model, sched, weight_decay, freeze_paths, grad_clip, accumulate_steps,
                     train_paths_override, zero)
