"""RPN head, its loss and its proposal decode (torch).

Counterpart of ``rsprompter_tpu/models/dense_heads/rpn_head.py``: a shared
3x3 conv + ReLU, then 1x1 class-agnostic scores (A per position) and deltas
(4A); the loss assigns every anchor by max IoU, samples 256 at half
positives and takes sigmoid CE plus smooth L1 as one masked reduction;
proposals by per-level top-k -> decode -> clip -> global top-k ->
level-separated NMS, padded to ``max_per_img`` with a validity mask.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.losses import binary_cross_entropy, smooth_l1
from rsprompter_tpu_torch.models.sam.common import Conv2d
from rsprompter_tpu_torch.models.task_modules.anchor_generator import AnchorGenerator
from rsprompter_tpu_torch.models.task_modules.assigners import max_iou_assign
from rsprompter_tpu_torch.models.task_modules.samplers import random_sample_padded
from rsprompter_tpu_torch.ops.boxes import DeltaXYWHBBoxCoder, clip_to_shape, take_per_image
from rsprompter_tpu_torch.ops.nms import batched_nms, sort_desc


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_base_priors: int = 6):
        super().__init__()
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = Conv2d(feat_channels, num_base_priors, 1)
        self.rpn_reg = Conv2d(feat_channels, num_base_priors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, bbox_preds = [], []
        for x in feats:
            y = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(y))
            bbox_preds.append(self.rpn_reg(y))
        return cls_scores, bbox_preds


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, N, 4)
    scores: torch.Tensor  # (B, N)
    valid: torch.Tensor  # (B, N) bool


def rpn_loss(
    cls_scores: List[torch.Tensor],
    bbox_preds: List[torch.Tensor],
    anchors: torch.Tensor,  # (P, 4), all levels
    gt_bboxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
    rand: torch.Tensor,  # (3, B, P) sampler draws
    cfg: Dict[str, Any],
) -> Dict[str, torch.Tensor]:
    b = cls_scores[0].shape[0]
    scores = torch.cat([s.reshape(b, -1) for s in cls_scores], dim=1)  # (B, P)
    deltas = torch.cat([d.reshape(b, -1, 4) for d in bbox_preds], dim=1)
    coder = DeltaXYWHBBoxCoder(
        cfg.get("target_means", (0, 0, 0, 0)), cfg.get("target_stds", (1, 1, 1, 1))
    )
    g = gt_bboxes.shape[1]
    gt_inds = max_iou_assign(
        anchors, gt_bboxes, gt_valid, pos_iou_thr=cfg.get("pos_iou_thr", 0.7),
        neg_iou_thr=cfg.get("neg_iou_thr", 0.3), min_pos_iou=cfg.get("min_pos_iou", 0.3),
    )
    sample = random_sample_padded(
        gt_inds, rand, num=cfg.get("num", 256), pos_fraction=cfg.get("pos_fraction", 0.5),
    )
    zeros = torch.zeros_like(scores, dtype=torch.float32)
    label_w = zeros.scatter_reduce(1, sample.inds, sample.valid.float(), "amax")
    pos_w = zeros.scatter_reduce(1, sample.inds, sample.is_pos.float(), "amax")
    safe = (gt_inds - 1).clamp(0, g - 1)
    matched_gt = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
    bbox_target = coder.encode(anchors, matched_gt)
    avg = sample.valid.sum().float().clamp(min=1.0)
    loss_cls = binary_cross_entropy(scores, pos_w, weight=label_w, avg_factor=avg)
    loss_bbox = smooth_l1(
        deltas, bbox_target, beta=cfg.get("smooth_l1_beta", 1.0),
        weight=pos_w[..., None], avg_factor=avg,
    )
    return {"loss_rpn_cls": loss_cls, "loss_rpn_bbox": loss_bbox}


def rpn_predict(
    cls_scores: List[torch.Tensor],
    bbox_preds: List[torch.Tensor],
    level_anchors: Sequence,  # per level (H*W*A, 4), numpy or tensors
    img_shapes: torch.Tensor,  # (B, 2) valid (h, w)
    cfg: Dict[str, Any],
) -> Proposals:
    nms_pre = cfg.get("nms_pre", 1000)
    max_per_img = cfg.get("max_per_img", 1000)
    iou_thr = cfg.get("nms_iou_thr", 0.7)
    pre_nms_total = cfg.get("pre_nms_total", 2000)
    b = cls_scores[0].shape[0]
    dev = cls_scores[0].device
    coder = DeltaXYWHBBoxCoder()

    cand_scores, cand_boxes, cand_levels = [], [], []
    for lvl, (score_map, delta_map, anchors) in enumerate(
        zip(cls_scores, bbox_preds, level_anchors)
    ):
        s = torch.sigmoid(score_map.reshape(b, -1).float())
        d = delta_map.reshape(b, -1, 4)
        k = min(nms_pre, s.shape[1])
        top_s, top_i = sort_desc(s, k)
        top_a = torch.as_tensor(anchors, device=dev)[top_i]
        cand_scores.append(top_s)
        cand_boxes.append(coder.decode(top_a, take_per_image(d, top_i)))
        cand_levels.append(torch.full((b, k), lvl, dtype=torch.int32, device=dev))
    scores = torch.cat(cand_scores, dim=1)
    boxes = clip_to_shape(torch.cat(cand_boxes, dim=1), img_shapes[:, None, :].float())
    levels = torch.cat(cand_levels, dim=1)

    k = min(pre_nms_total, scores.shape[1])
    top_s, top_i = sort_desc(scores, k)
    top_b = take_per_image(boxes, top_i)
    top_l = torch.gather(levels, 1, top_i)
    min_sz = cfg.get("min_bbox_size", 0)
    wh_valid = ((top_b[..., 2] - top_b[..., 0]) > min_sz) & (
        (top_b[..., 3] - top_b[..., 1]) > min_sz
    )
    _, keep, out_boxes, out_scores = batched_nms(
        top_b, top_s, top_l, iou_thr=iou_thr, max_out=max_per_img, valid=wh_valid
    )
    return Proposals(out_boxes, out_scores, keep)


def build_rpn_anchor_generator(cfg: Dict[str, Any]) -> AnchorGenerator:
    return AnchorGenerator(
        strides=cfg.get("strides", (4, 8, 16, 32, 64)),
        ratios=cfg.get("ratios", (0.5, 1.0, 2.0)),
        scales=cfg.get("scales", (4, 8)),
    )
