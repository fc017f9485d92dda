"""MaxIoU assignment with static shapes (torch, batched).

Counterpart of ``rsprompter_tpu/models/task_modules/assigners.py``
(``max_iou_assign`` :29), the reference's ``MaxIoUAssigner`` with its
``match_low_quality`` pass (each gt claims its best-overlap priors, later gts
override earlier ones). Padded gt rows are masked out of the overlap matrix,
so they never assign. A leading batch dimension replaces JAX's ``vmap``. The
port's callers read only the assigned gt indices, so JAX's overlaps, labels
and prior mask are not carried.
"""

from __future__ import annotations

import torch

from rsprompter_tpu_torch.ops.boxes import bbox_overlaps


def max_iou_assign(
    priors: torch.Tensor,  # (P, 4) or (B, P, 4)
    gt_bboxes: torch.Tensor,  # (B, G, 4) padded
    gt_valid: torch.Tensor,  # (B, G) bool
    pos_iou_thr: float = 0.7,
    neg_iou_thr: float = 0.3,
    min_pos_iou: float = 0.3,
) -> torch.Tensor:
    """(B, P) int64 gt index per prior: -1 ignore, 0 negative, i+1 -> gt i."""
    b, g = gt_valid.shape
    overlaps = bbox_overlaps(gt_bboxes, priors.expand(b, *priors.shape[-2:]))  # (B, G, P)
    overlaps = torch.where(gt_valid[..., None], overlaps, 0.0)

    max_overlaps, argmax_gt = overlaps.max(dim=1)
    assigned = torch.full_like(argmax_gt, -1)
    # mmdet semantics: negatives are max_overlaps in [0, neg_thr)
    assigned = torch.where(max_overlaps < neg_iou_thr, 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_gt + 1, assigned)

    # match_low_quality: each gt claims its best-overlap priors
    gt_max = overlaps.max(dim=2, keepdim=True).values  # (B, G, 1)
    claim = (overlaps == gt_max) & (gt_max >= min_pos_iou) & gt_valid[..., None]
    gt_ids = torch.arange(1, g + 1, device=overlaps.device)[None, :, None]
    lowq = torch.where(claim, gt_ids, 0).max(dim=1).values  # later gt wins
    return torch.where(lowq > 0, lowq, assigned)
