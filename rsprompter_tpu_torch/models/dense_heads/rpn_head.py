"""RPN head, its loss and its proposal decode (torch).

Counterpart of ``rsprompter_tpu/models/dense_heads/rpn_head.py``: a shared
3x3 conv + ReLU, then 1x1 class-agnostic scores (A per position) and deltas
(4A); the loss assigns every anchor by max IoU, samples 256 at half
positives and takes sigmoid CE plus smooth L1 as one masked reduction;
proposals by per-level top-k -> decode -> clip -> global top-k ->
level-separated NMS, padded to ``max_per_img`` with a validity mask.
:func:`propose` (test time) and :func:`two_stage_loss` (the train step: the
RPN's loss and the proposals of its detached outputs, with
``rpn_train_cfgs``, JAX's ``_rpn_cfgs``, then the RoI head's loss) serve the
three two-stage detectors.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
from rsprompter_tpu_torch.parallel.distributed import global_count, local_rows, world_size


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
    avg = global_count(sample.valid.sum().float())
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


def propose(rpn_head: RPNHead, anchor_generator: AnchorGenerator,
            feats: Sequence[torch.Tensor], img_shapes: torch.Tensor,
            test_cfg: Dict[str, Any]):
    """The two-stage detectors' test-time proposals: the RPN head on
    ``feats``, then :func:`rpn_predict` with ``test_cfg['rpn']`` over the
    defaults nms_pre 1000, max_per_img 1000, IoU 0.7. Returns (per-level
    scores, per-level deltas, :class:`Proposals`): ``mode='tensor'``
    returns the first two raw."""
    cls_scores, bbox_preds = rpn_head(feats)
    rpn_cfg = dict(nms_pre=1000, max_per_img=1000, nms_iou_thr=0.7)
    rpn_cfg.update(test_cfg.get("rpn", {}))
    return cls_scores, bbox_preds, rpn_predict(
        cls_scores, bbox_preds, anchor_generator.device_anchors(feats), img_shapes, rpn_cfg)


def rpn_train_cfgs(train_cfg: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the RPN sampler's config, the train proposals' config): the
    defaults of JAX's ``_rpn_cfgs`` under ``train_cfg['rpn']`` and
    ``train_cfg['rpn_proposal']``."""
    rpn_train = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3, num=256,
                     pos_fraction=0.5)
    rpn_train.update(train_cfg.get("rpn", {}))
    rpn_proposal = dict(nms_pre=2000, max_per_img=1000, nms_iou_thr=0.7)
    rpn_proposal.update(train_cfg.get("rpn_proposal", {}))
    return rpn_train, rpn_proposal


def two_stage_loss(rpn_head: RPNHead, anchor_generator: AnchorGenerator, roi_head: nn.Module,
                   feats: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
                   train_cfg: Dict[str, Any], generator: Optional[torch.Generator],
                   draws: Optional[Dict[str, torch.Tensor]], *roi_extra: Any,
                   ) -> Dict[str, torch.Tensor]:
    """The two-stage detectors' train step on their features: the RPN's
    loss terms, its proposals from the detached outputs (JAX's
    stop-gradient), then ``roi_head.loss`` on them, ``roi_extra`` passed
    before its draws. ``draws`` {'rpn': (3, B, P), 'roi': (3, B, G + N)} are
    the samplers' uniforms for the global batch (the ranks' batches in rank
    order; this batch at world 1); without them they come from
    ``generator``, which every rank seeds alike. Each rank keeps its own
    rows."""
    b, g = batch["gt_valid"].shape

    def draw(name: str, n: int) -> torch.Tensor:
        full = draws[name] if draws is not None else torch.rand(
            (3, world_size() * b, n), generator=generator, device=feats[0].device)
        return local_rows(full, 1, b)

    cls_scores, bbox_preds = rpn_head(feats)
    level_anchors = anchor_generator.device_anchors(feats)
    anchors = torch.cat(level_anchors, dim=0)
    sampler_cfg, proposal_cfg = rpn_train_cfgs(train_cfg)
    losses = rpn_loss(cls_scores, bbox_preds, anchors, batch["gt_bboxes"], batch["gt_valid"],
                      draw("rpn", anchors.shape[0]), sampler_cfg)
    proposals = rpn_predict([s.detach() for s in cls_scores], [d.detach() for d in bbox_preds],
                            level_anchors, batch["img_shape"], proposal_cfg)
    losses.update(roi_head.loss(
        feats, proposals.boxes, proposals.valid, batch["gt_bboxes"], batch["gt_labels"],
        batch["gt_valid"], batch.get("gt_masks"), *roi_extra,
        draw("roi", g + proposals.boxes.shape[1])))
    return losses


def build_rpn_anchor_generator(cfg: Dict[str, Any]) -> AnchorGenerator:
    return AnchorGenerator(
        strides=cfg.get("strides", (4, 8, 16, 32, 64)),
        ratios=cfg.get("ratios", (0.5, 1.0, 2.0)),
        scales=cfg.get("scales", (4, 8)),
    )
