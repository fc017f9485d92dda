"""Two-stage RoI heads (torch, batched): proposal sampling and the
standard bbox + mask head's loss and predict.

Counterpart of ``rsprompter_tpu/models/roi_heads/standard_roi_head.py``:

* ``sample_proposals_batch`` (:36): gt boxes are prepended as proposals,
  every proposal is assigned by max IoU (0.5 / 0.5 / 0.5) and ``num`` are
  sampled with positives first;
* ``StandardRoIHead``, the head of SAM-det's detector (``with_mask=False``)
  and of SAM-seg Mask R-CNN. ``loss`` (:117-180): ``num_samples`` RoIs
  sampled per image (positives packed first), 7^2 RoI features through
  ``Shared2FCBBoxHead`` and its loss; with the mask head, the first
  ``num_mask_slots`` slots' 14^2 RoI features through ``FCNMaskHead``
  against their matched GT masks cropped to 28^2 (``mask_targets_from_rois``,
  a fixed 2 x 2 samples a bin, where the features take the adaptive rule of
  ``roi_sampling_ratio=0``). ``predict`` (:207-254): the proposals' bbox
  head and the per-class decode + NMS, then 14^2 RoI features of the
  detections through the mask head, the detection's class channel (or the
  one channel of a class-agnostic head) and a sigmoid. ``tensor``
  (:171-205): the raw outputs of ``mode='tensor'``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.roi_heads.bbox_head import (
    DetResult,
    Shared2FCBBoxHead,
    bbox_head_loss,
    bbox_head_predict,
)
from rsprompter_tpu_torch.models.roi_heads.mask_head import (
    FCNMaskHead,
    fcn_mask_loss,
    mask_targets_from_rois,
)
from rsprompter_tpu_torch.models.roi_heads.roi_extractor import extract_roi_feats
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


def boxes_to_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) -> (B*N, 5) with the batch index prepended."""
    b, n, _ = boxes.shape
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device).repeat_interleave(n)
    return torch.cat([idx[:, None], boxes.reshape(b * n, 4)], dim=1)


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


class SampledBBoxLoss:
    """What the standard and the prompt RoI heads share: RoI features of
    boxes, the mask branch's slots, and the sampling + bbox head loss of the
    train step. The head sets ``featmap_strides``, ``roi_sampling_ratio``,
    ``bbox_roi_size``, ``num_samples``, ``pos_fraction``, ``num_classes``,
    ``target_stds`` and ``bbox_head``."""

    def _roi_feats(self, feats: Sequence[torch.Tensor], boxes: torch.Tensor, size: int):
        return extract_roi_feats(
            feats[: len(self.featmap_strides)], boxes_to_rois(boxes), (size, size),
            self.featmap_strides, sampling_ratio=self.roi_sampling_ratio,
        )

    @property
    def num_mask_slots(self) -> int:
        """The mask branch's slots: the first ``num_samples * pos_fraction``
        (positives are packed first)."""
        return max(int(self.num_samples * self.pos_fraction), 1)

    def sampled_bbox_loss(self, feats, proposals, proposal_valid, gt_bboxes, gt_labels,
                          gt_valid, rand) -> Tuple[SampledRois, Dict[str, torch.Tensor]]:
        """Sample ``num_samples`` RoIs an image (the GT added as proposals),
        then the bbox head's loss on their 7^2 features."""
        smp = sample_proposals_batch(
            rand, proposals, proposal_valid, gt_bboxes, gt_labels, gt_valid,
            num=self.num_samples, pos_fraction=self.pos_fraction,
        )
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, smp.boxes, self.bbox_roi_size))
        flat_labels = smp.labels.reshape(-1)
        flat_labels = torch.where(flat_labels >= 0, flat_labels, self.num_classes)
        return smp, bbox_head_loss(
            cls_logits, bbox_deltas, smp.boxes.reshape(-1, 4), flat_labels,
            smp.matched_gt.reshape(-1, 4), smp.valid.reshape(-1), smp.is_pos.reshape(-1),
            self.num_classes, self.target_stds,
        )


class StandardRoIHead(SampledBBoxLoss, nn.Module):
    def __init__(self, num_classes: int = 1,
                 featmap_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 bbox_roi_size: int = 7, mask_roi_size: int = 14,
                 roi_sampling_ratio: int = 0, with_mask: bool = True,
                 class_agnostic_mask: bool = False, num_samples: int = 512,
                 pos_fraction: float = 0.25,
                 target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                 test_cfg: Any = None):
        super().__init__()
        self.num_classes = num_classes
        self.featmap_strides = tuple(featmap_strides)
        self.bbox_roi_size = bbox_roi_size
        self.mask_roi_size = mask_roi_size
        self.roi_sampling_ratio = roi_sampling_ratio
        self.class_agnostic_mask = class_agnostic_mask
        self.num_samples = num_samples  # the train step's sampler
        self.pos_fraction = pos_fraction
        self.target_stds = tuple(target_stds)
        self.test_cfg = dict(test_cfg or {})
        self.bbox_head = Shared2FCBBoxHead(num_classes, roi_size=bbox_roi_size)
        self.mask_head = (FCNMaskHead(num_classes, class_agnostic=class_agnostic_mask)
                          if with_mask else None)

    def loss(
        self,
        feats: Sequence[torch.Tensor],
        proposals: torch.Tensor,  # (B, N, 4), no gradient
        proposal_valid: torch.Tensor,  # (B, N)
        gt_bboxes: torch.Tensor,  # (B, G, 4)
        gt_labels: torch.Tensor,  # (B, G)
        gt_valid: torch.Tensor,  # (B, G)
        gt_masks: Optional[torch.Tensor],  # (B, G, H, W) 0 / 1; unused without a mask head
        rand: torch.Tensor,  # (3, B, G + N) sampler draws
    ) -> Dict[str, torch.Tensor]:
        smp, losses = self.sampled_bbox_loss(feats, proposals, proposal_valid, gt_bboxes,
                                             gt_labels, gt_valid, rand)
        if self.mask_head is None:
            return losses
        m = self.num_mask_slots
        boxes = smp.boxes[:, :m]
        logits = self.mask_head(self._roi_feats(feats, boxes, self.mask_roi_size))
        size = 2 * self.mask_roi_size  # the mask head's deconv doubles its input
        targets = mask_targets_from_rois(gt_masks, boxes_to_rois(boxes),
                                         smp.gt_inds[:, :m].reshape(-1), (size, size))
        losses["loss_mask"] = fcn_mask_loss(
            logits, targets, smp.labels[:, :m].reshape(-1).clamp(min=0),
            (smp.is_pos[:, :m] & smp.valid[:, :m]).reshape(-1), self.class_agnostic_mask,
        )
        return losses

    def tensor(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor):
        """Raw outputs on the proposals (B, N, 4), no decode, NMS or paste
        (JAX :171): (cls_logits (B, N, C+1), bbox_deltas (B, N, 4C)), and
        with the mask head its logits on the first min(N, 100) proposals
        (B, M, S, S, C or 1), as the reference's ``forward`` slices them."""
        b, n, _ = proposals.shape
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, proposals, self.bbox_roi_size))
        out = (cls_logits.reshape(b, n, -1), bbox_deltas.reshape(b, n, -1))
        if self.mask_head is None:
            return out
        m = min(n, 100)
        logits = self.mask_head(self._roi_feats(feats, proposals[:, :m], self.mask_roi_size))
        s = logits.shape[-2]
        return out + (logits.reshape(b, m, s, s, -1),)

    def predict(
        self,
        feats: Sequence[torch.Tensor],
        proposals: torch.Tensor,  # (B, N, 4)
        proposal_valid: torch.Tensor,  # (B, N)
        img_shapes: torch.Tensor,  # (B, 2)
    ) -> Tuple[DetResult, Optional[torch.Tensor]]:
        """(detections (B, max_per_img, ...), mask probabilities (B,
        max_per_img, 28, 28) fp32, or None without a mask head)."""
        b, n, _ = proposals.shape
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, proposals, self.bbox_roi_size))
        dets = bbox_head_predict(
            cls_logits.reshape(b, n, -1), bbox_deltas.reshape(b, n, -1), proposals,
            proposal_valid, img_shapes, self.num_classes, self.test_cfg, self.target_stds,
        )
        if self.mask_head is None:
            return dets, None
        logits = self.mask_head(self._roi_feats(feats, dets.boxes, self.mask_roi_size))
        if self.class_agnostic_mask:
            sel = logits[..., 0]
        else:
            lab = dets.labels.reshape(-1).clamp(0, self.num_classes - 1)
            sel = torch.gather(logits, 3, lab[:, None, None, None].expand(
                -1, logits.shape[1], logits.shape[2], 1))[..., 0]
        s = sel.shape[-1]
        return dets, torch.sigmoid(sel.float()).reshape(b, -1, s, s)
