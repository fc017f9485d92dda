"""Proposal sampling of the two-stage RoI heads (torch, batched).

Counterpart of ``sample_proposals_batch`` in
``rsprompter_tpu/models/roi_heads/standard_roi_head.py`` (:36): gt boxes are
prepended as proposals, every proposal is assigned by max IoU (0.5 / 0.5 /
0.5) and ``num`` are sampled with positives first. The rest of the JAX
``StandardRoIHead`` (the Mask R-CNN family) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsprompter_tpu_torch.models.task_modules.assigners import max_iou_assign
from rsprompter_tpu_torch.models.task_modules.samplers import random_sample_padded
from rsprompter_tpu_torch.ops.boxes import take_per_image


class SampledRois(NamedTuple):
    boxes: torch.Tensor  # (B, num, 4)
    labels: torch.Tensor  # (B, num) gt class of positives, -1 otherwise
    matched_gt: torch.Tensor  # (B, num, 4)
    valid: torch.Tensor  # (B, num) bool
    is_pos: torch.Tensor  # (B, num) bool
    gt_inds: torch.Tensor  # (B, num) 1-based gt index of positives, else 0


def sample_proposals_batch(
    rand: torch.Tensor,  # (3, B, G + N) sampler draws
    proposals: torch.Tensor,  # (B, N, 4)
    proposal_valid: torch.Tensor,  # (B, N)
    gt_bboxes: torch.Tensor,  # (B, G, 4)
    gt_labels: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G)
    num: int = 512,
    pos_fraction: float = 0.25,
    pos_iou_thr: float = 0.5,
    neg_iou_thr: float = 0.5,
    min_pos_iou: float = 0.5,
) -> SampledRois:
    """Sampled RoIs and their targets, all (B, num, ...), with the gt boxes
    added as proposals."""
    boxes = torch.cat([gt_bboxes, proposals], dim=1)
    bvalid = torch.cat([gt_valid, proposal_valid], dim=1)
    boxes = torch.where(bvalid[..., None], boxes, 0.0)  # padding: zero overlap
    assigned = max_iou_assign(
        boxes, gt_bboxes, gt_valid, pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
        min_pos_iou=min_pos_iou,
    )
    gt_inds = torch.where(bvalid, assigned, -1)
    sample = random_sample_padded(gt_inds, rand, num=num, pos_fraction=pos_fraction)
    safe_gt = (sample.gt_inds - 1).clamp(0, gt_bboxes.shape[1] - 1)
    labels = torch.where(sample.is_pos, torch.gather(gt_labels.long(), 1, safe_gt), -1)
    return SampledRois(
        take_per_image(boxes, sample.inds), labels, take_per_image(gt_bboxes, safe_gt),
        sample.valid, sample.is_pos, sample.gt_inds,
    )
