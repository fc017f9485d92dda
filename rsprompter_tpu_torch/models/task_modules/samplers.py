"""Static-shape random positive / negative sampling (torch, batched).

Counterpart of ``rsprompter_tpu/models/task_modules/samplers.py``
(``random_sample_padded`` :34), the reference's ``RandomSampler``: up to
``num * pos_fraction`` positives, the rest negatives, uniformly at random, as
a fixed-length index vector (positives first) with validity and positivity
masks.

The uniform draws are an input, ``rand`` (3, B, P): in use they come from a
``torch.Generator``; tests hand in the draws JAX's own key splits produce
(PARITY.md deviation 3: the two frameworks' generators give different
numbers). Ranks use stable sorts, as ``jnp.argsort`` does, so equal keys keep
index order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SampleResult(NamedTuple):
    inds: torch.Tensor  # (B, num) int64 indices into the priors
    valid: torch.Tensor  # (B, num) bool
    is_pos: torch.Tensor  # (B, num) bool
    gt_inds: torch.Tensor  # (B, num) 1-based gt index for positives, else 0


def _group_rank(member: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Rank of each member within its group by ``rand`` (0..k-1); others P."""
    p = member.shape[-1]
    key = torch.where(member, rand, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(p, device=order.device).expand_as(order))
    return torch.where(member, rank, p)


def random_sample_padded(
    assigned_gt_inds: torch.Tensor,  # (B, P) from max_iou_assign
    rand: torch.Tensor,  # (3, B, P) uniform draws in [0, 1)
    num: int = 256,
    pos_fraction: float = 0.5,
) -> SampleResult:
    is_pos = assigned_gt_inds > 0
    is_neg = assigned_gt_inds == 0
    num_expected_pos = int(num * pos_fraction)

    sel_pos = is_pos & (_group_rank(is_pos, rand[0]) < num_expected_pos)
    num_pos = sel_pos.sum(dim=-1, keepdim=True)
    sel_neg = is_neg & (_group_rank(is_neg, rand[1]) < (num - num_pos))

    # order: positives first (stable slots for the mask head), then negatives
    priority = sel_pos.float() * 2.0 + sel_neg.float() + rand[2] * 1e-3
    inds = torch.argsort(-priority, dim=-1, stable=True)[:, :num]
    valid = torch.gather(sel_pos | sel_neg, 1, inds)
    pos = torch.gather(sel_pos, 1, inds)
    gt_inds = torch.where(pos, torch.gather(assigned_gt_inds, 1, inds), 0)
    return SampleResult(inds, valid, pos, gt_inds)
