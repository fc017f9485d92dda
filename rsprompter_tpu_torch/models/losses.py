"""Weighted detection losses (torch).

Counterpart of ``rsprompter_tpu/models/losses.py``: softmax and sigmoid
cross-entropy, smooth L1, the per-instance mask CE and accuracy, each with an
elementwise ``weight`` (or ``valid`` mask) and an ``avg_factor`` normaliser --
the masked static-shape idiom the JAX package uses instead of boolean
indexing; the port's callers use only that form of JAX's ``_reduce`` (:19). Each
loss computes in its logits' dtype, as the JAX functions do; the weighted
reduction promotes to the weight's fp32. Focal and dice losses belong to the
query family and are not ported yet.
"""

from __future__ import annotations

import torch


def _reduce(loss: torch.Tensor, weight: torch.Tensor, avg_factor) -> torch.Tensor:
    """sum(loss * weight) / avg_factor (JAX ``_reduce``, reduction 'mean')."""
    return (loss * weight).sum() / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)


def _bce_with_logits(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
                  avg_factor) -> torch.Tensor:
    """Softmax CE with integer labels: (..., C) vs (...,)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _reduce(nll, weight, avg_factor)


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, weight: torch.Tensor,
                         avg_factor) -> torch.Tensor:
    """Sigmoid BCE with logits; targets of the same shape (0/1)."""
    return _reduce(_bce_with_logits(logits, targets.to(logits.dtype)), weight, avg_factor)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float, weight: torch.Tensor,
              avg_factor) -> torch.Tensor:
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _reduce(loss, weight, avg_factor)


def mask_cross_entropy(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Per-instance binary mask CE: (N, H, W) logits and targets, averaged
    over pixels per instance, then over the valid instances."""
    loss = _bce_with_logits(mask_logits, mask_targets.to(mask_logits.dtype))
    per_inst = loss.mean(dim=(-2, -1)) * valid.to(loss.dtype)
    return per_inst.sum() / valid.sum().clamp(min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    correct = (logits.argmax(dim=-1) == labels).float()
    v = valid.float()
    return (correct * v).sum() / v.sum().clamp(min=1.0)
