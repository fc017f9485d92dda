"""RoI head of RSPrompter-anchor: bbox head + SAM-prompting mask head.

Counterpart of ``rsprompter_tpu/models/roi_heads/prompt_roi_head.py``:
optional extra sine PE (computed at level-0 size and resized onto every level
with ``jax.image.resize``'s antialiased bilinear weights), then

- ``loss`` (:120): sample proposals (gt boxes added), RoIAlign -> bbox head
  loss; the mask branch runs on the packed positive slots (the first
  ``num_samples * pos_fraction``), upsamples SAM's low-res masks bilinearly
  to the gt size and takes the per-instance mask CE;
- ``predict`` (:218): RoIAlign -> bbox head -> per-class NMS, then
  full-frame SAM masks for the detections.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.layers import sine_positional_encoding
from rsprompter_tpu_torch.models.losses import mask_cross_entropy
from rsprompter_tpu_torch.models.roi_heads.bbox_head import (
    DetResult,
    Shared2FCBBoxHead,
    bbox_head_loss,
    bbox_head_predict,
)
from rsprompter_tpu_torch.models.roi_heads.prompt_mask_head import RSPrompterAnchorMaskHead
from rsprompter_tpu_torch.models.roi_heads.roi_extractor import extract_roi_feats
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import sample_proposals_batch
from rsprompter_tpu_torch.models.sam.configs import SamMaskDecoderConfig
from rsprompter_tpu_torch.ops.boxes import take_per_image
from rsprompter_tpu_torch.ops.resize import resize


def add_extra_pe(feats: Sequence[torch.Tensor], num_feats: int) -> Tuple[torch.Tensor, ...]:
    """Add sine PE (computed at level-0 size, resized per level) to each map."""
    h0, w0 = feats[0].shape[1:3]
    pe = sine_positional_encoding(h0, w0, num_feats=num_feats)[None].to(feats[0].device)
    out = []
    for f in feats:
        pe_l = resize(pe, (1, f.shape[1], f.shape[2], pe.shape[-1]), "bilinear")
        out.append(f + pe_l.to(f.dtype))
    return tuple(out)


def boxes_to_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) -> (B*N, 5) with the batch index prepended."""
    b, n, _ = boxes.shape
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device).repeat_interleave(n)
    return torch.cat([idx[:, None], boxes.reshape(b * n, 4)], dim=1)


class RSPrompterAnchorRoIPromptHead(nn.Module):
    def __init__(self, decoder_config: SamMaskDecoderConfig, num_classes: int = 1,
                 featmap_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 bbox_roi_size: int = 7, mask_roi_size: int = 14,
                 roi_sampling_ratio: int = 0, with_extra_pe: bool = True,
                 per_pointset_point: int = 5, with_sincos: bool = True,
                 multimask_output: bool = False, num_samples: int = 256,
                 pos_fraction: float = 0.25,
                 target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                 test_cfg: Any = None):
        super().__init__()
        self.num_classes = num_classes
        self.num_samples = num_samples
        self.pos_fraction = pos_fraction
        self.featmap_strides = tuple(featmap_strides)
        self.bbox_roi_size = bbox_roi_size
        self.mask_roi_size = mask_roi_size
        self.roi_sampling_ratio = roi_sampling_ratio
        self.with_extra_pe = with_extra_pe
        self.target_stds = tuple(target_stds)
        self.test_cfg = dict(test_cfg or {})
        self.bbox_head = Shared2FCBBoxHead(num_classes, roi_size=bbox_roi_size)
        self.mask_head = RSPrompterAnchorMaskHead(
            decoder_config, roi_feat_size=mask_roi_size,
            per_pointset_point=per_pointset_point, with_sincos=with_sincos,
            multimask_output=multimask_output,
        )

    def _roi_feats(self, feats, boxes, size):
        return extract_roi_feats(
            feats[: len(self.featmap_strides)], boxes_to_rois(boxes), (size, size),
            self.featmap_strides, sampling_ratio=self.roi_sampling_ratio,
        )

    @property
    def num_mask_slots(self) -> int:
        return max(int(self.num_samples * self.pos_fraction), 1)

    def _mask_logits(self, feats, boxes, image_embeddings, image_pe):
        """boxes (B, R, 4) -> SAM low-res mask logits (B, R, S, S)."""
        b, r, _ = boxes.shape
        mask_feats = self._roi_feats(feats, boxes, self.mask_roi_size)
        masks, _ = self.mask_head(
            mask_feats.reshape((b, r) + mask_feats.shape[1:]), image_embeddings, image_pe
        )
        s = masks.shape[-1]
        return masks.reshape(b, r, s, s)

    def loss(
        self,
        feats: Sequence[torch.Tensor],
        proposals: torch.Tensor,  # (B, N, 4), no gradient
        proposal_valid: torch.Tensor,  # (B, N)
        gt_bboxes: torch.Tensor,  # (B, G, 4)
        gt_labels: torch.Tensor,  # (B, G)
        gt_valid: torch.Tensor,  # (B, G)
        gt_masks: torch.Tensor,  # (B, G, H, W) full image size, 0/1
        image_embeddings: torch.Tensor,
        image_pe: torch.Tensor,
        rand: torch.Tensor,  # (3, B, G + N) sampler draws
    ) -> Dict[str, torch.Tensor]:
        if self.with_extra_pe:
            feats = add_extra_pe(feats, num_feats=feats[0].shape[-1] // 2)
        b = proposals.shape[0]
        smp = sample_proposals_batch(
            rand, proposals, proposal_valid, gt_bboxes, gt_labels, gt_valid,
            num=self.num_samples, pos_fraction=self.pos_fraction,
        )
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, smp.boxes, self.bbox_roi_size)
        )
        flat_labels = smp.labels.reshape(-1)
        flat_labels = torch.where(flat_labels >= 0, flat_labels, self.num_classes)
        losses = bbox_head_loss(
            cls_logits, bbox_deltas, smp.boxes.reshape(-1, 4), flat_labels,
            smp.matched_gt.reshape(-1, 4), smp.valid.reshape(-1), smp.is_pos.reshape(-1),
            self.num_classes, self.target_stds,
        )

        # mask branch on the packed positive slots; gradients reach point_emb
        # through the decoder even when the decoder's parameters are frozen
        m = self.num_mask_slots
        pos_mask = smp.is_pos[:, :m] & smp.valid[:, :m]
        mask_logits = self._mask_logits(feats, smp.boxes[:, :m], image_embeddings, image_pe)
        g = gt_masks.shape[1]
        safe_gt = (smp.gt_inds[:, :m] - 1).clamp(0, g - 1)
        targets = take_per_image(gt_masks, safe_gt)
        th, tw = targets.shape[-2:]
        preds = resize(mask_logits, (b, m, th, tw), "bilinear")
        losses["loss_mask"] = mask_cross_entropy(
            preds.reshape(b * m, th, tw), targets.reshape(b * m, th, tw),
            valid=pos_mask.reshape(-1),
        )
        return losses

    def predict(
        self,
        feats: Sequence[torch.Tensor],
        proposals: torch.Tensor,  # (B, N, 4)
        proposal_valid: torch.Tensor,  # (B, N)
        img_shapes: torch.Tensor,  # (B, 2)
        image_embeddings: torch.Tensor,
        image_pe: torch.Tensor,
    ) -> Tuple[DetResult, torch.Tensor]:
        if self.with_extra_pe:
            feats = add_extra_pe(feats, num_feats=feats[0].shape[-1] // 2)
        b, n, _ = proposals.shape
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, proposals, self.bbox_roi_size)
        )
        dets = bbox_head_predict(
            cls_logits.reshape(b, n, -1), bbox_deltas.reshape(b, n, -1), proposals,
            proposal_valid, img_shapes, self.num_classes, self.test_cfg, self.target_stds,
        )
        masks = self._mask_logits(feats, dets.boxes, image_embeddings, image_pe)
        return dets, torch.sigmoid(masks.float())
