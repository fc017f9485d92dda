"""Shared-2FC bbox head, its masked loss and its test-time decode +
per-class NMS (torch).

Counterpart of ``rsprompter_tpu/models/roi_heads/bbox_head.py``: flatten RoI
features -> 2 x 1024 FC -> class logits (C + 1) and class-specific deltas
(4C, stds (.1, .1, .2, .2)); the loss is softmax CE over the sampled slots
and smooth L1 on the positives' deltas of their class; prediction keeps fixed
shapes (padded to ``max_per_img`` with a keep mask). The flatten is NCHW, as
in the reference torch head.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.losses import accuracy, cross_entropy, smooth_l1
from rsprompter_tpu_torch.models.sam.common import Linear
from rsprompter_tpu_torch.ops.boxes import DeltaXYWHBBoxCoder, clip_to_shape
from rsprompter_tpu_torch.ops.nms import batched_nms, sort_desc
from rsprompter_tpu_torch.parallel.distributed import global_count


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 1, in_channels: int = 256, roi_size: int = 7,
                 fc_out_channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            Linear(in_channels * roi_size * roi_size, fc_out_channels),
            Linear(fc_out_channels, fc_out_channels),
        ])
        self.fc_cls = Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = Linear(fc_out_channels, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (R, h, w, C) -> (cls_logits (R, C+1), deltas (R, 4C))."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


def bbox_head_loss(
    cls_logits: torch.Tensor,  # (R, C+1)
    bbox_deltas: torch.Tensor,  # (R, 4C)
    sampled_boxes: torch.Tensor,  # (R, 4)
    labels: torch.Tensor,  # (R,) gt class of positives, C (background) otherwise
    matched_gt_boxes: torch.Tensor,  # (R, 4)
    valid: torch.Tensor,  # (R,)
    is_pos: torch.Tensor,  # (R,)
    num_classes: int,
    target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
) -> Dict[str, torch.Tensor]:
    coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
    avg = global_count(valid.sum().float())
    loss_cls = cross_entropy(cls_logits, labels, weight=valid.float(), avg_factor=avg)
    targets = coder.encode(sampled_boxes, matched_gt_boxes)
    idx = labels.clamp(0, num_classes - 1).long()
    pred = bbox_deltas.reshape(-1, num_classes, 4)
    pred = torch.gather(pred, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    pos_w = (is_pos & valid).float()[:, None]
    loss_bbox = smooth_l1(pred, targets, beta=1.0, weight=pos_w, avg_factor=avg)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "acc": accuracy(cls_logits, labels, valid)}


class DetResult(NamedTuple):
    boxes: torch.Tensor  # (B, N, 4)
    scores: torch.Tensor  # (B, N)
    labels: torch.Tensor  # (B, N) int64
    valid: torch.Tensor  # (B, N) bool


def bbox_head_predict(
    cls_logits: torch.Tensor,  # (B, R, C+1)
    bbox_deltas: torch.Tensor,  # (B, R, 4C)
    proposals: torch.Tensor,  # (B, R, 4)
    proposal_valid: torch.Tensor,  # (B, R)
    img_shapes: torch.Tensor,  # (B, 2) (h, w)
    num_classes: int,
    cfg: Dict[str, Any],
    target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
) -> DetResult:
    """Per-image multiclass decode + NMS (``bbox_head_predict_single`` with
    the batch written out)."""
    score_thr = cfg.get("score_thr", 0.05)
    iou_thr = cfg.get("nms_iou_thr", 0.5)
    max_per_img = cfg.get("max_per_img", 100)
    nms_pre = cfg.get("nms_pre", 0)
    b, r, _ = proposals.shape
    dev = proposals.device

    coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
    scores = torch.softmax(cls_logits.float(), dim=-1)[..., :num_classes]
    deltas = bbox_deltas.reshape(b, r, num_classes, 4)
    boxes = coder.decode(proposals[:, :, None, :], deltas)  # (B, R, C, 4)
    boxes = clip_to_shape(boxes, img_shapes[:, None, None, :].float())

    flat_boxes = boxes.reshape(b, r * num_classes, 4)
    flat_scores = scores.reshape(b, r * num_classes)
    flat_labels = torch.arange(num_classes, device=dev).repeat(r)[None].expand(b, -1)
    flat_valid = proposal_valid.repeat_interleave(num_classes, dim=1) & (flat_scores > score_thr)
    if nms_pre and flat_scores.shape[1] > nms_pre:
        ranked = torch.where(flat_valid, flat_scores, float("-inf"))
        _, top_i = sort_desc(ranked, nms_pre)
        flat_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(b, nms_pre, 4))
        flat_scores = torch.gather(flat_scores, 1, top_i)
        flat_labels = torch.gather(flat_labels, 1, top_i)
        flat_valid = torch.gather(flat_valid, 1, top_i)
    idx, keep, out_boxes, out_scores = batched_nms(
        flat_boxes, flat_scores, flat_labels, iou_thr=iou_thr, max_out=max_per_img,
        valid=flat_valid,
    )
    out_labels = torch.where(keep, torch.gather(flat_labels, 1, idx), 0)
    return DetResult(out_boxes, out_scores, out_labels, keep)
