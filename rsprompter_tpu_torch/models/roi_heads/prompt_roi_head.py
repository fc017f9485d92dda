"""RoI head of RSPrompter-anchor: bbox head + SAM-prompting mask head.

Counterpart of ``rsprompter_tpu/models/roi_heads/prompt_roi_head.py``:
optional extra sine PE (computed at level-0 size and resized onto every level
with ``jax.image.resize``'s antialiased bilinear weights), then

- ``loss`` (:120): sample proposals (gt boxes added), RoIAlign -> bbox head
  loss; the mask branch runs on the packed positive slots (the first
  ``num_samples * pos_fraction``), upsamples SAM's low-res masks bilinearly
  to the gt size and takes the per-instance mask CE there, or, with
  ``mask_loss_resolution='low'`` (:171-182), resizes the targets to SAM's
  mask size instead (antialiased bilinear, as ``jax.image.resize``
  downsamples), thresholds them at 0.5 and takes the CE at that size;
- ``predict`` (:218): RoIAlign -> bbox head -> per-class NMS, then
  full-frame SAM masks for the detections;
- ``tensor`` (:190): the raw outputs of ``mode='tensor'``.
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
    bbox_head_predict,
)
from rsprompter_tpu_torch.models.roi_heads.prompt_mask_head import RSPrompterAnchorMaskHead
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import SampledBBoxLoss
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


class RSPrompterAnchorRoIPromptHead(SampledBBoxLoss, nn.Module):
    def __init__(self, decoder_config: SamMaskDecoderConfig, num_classes: int = 1,
                 featmap_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 bbox_roi_size: int = 7, mask_roi_size: int = 14,
                 roi_sampling_ratio: int = 0, with_extra_pe: bool = True,
                 per_pointset_point: int = 5, with_sincos: bool = True,
                 multimask_output: bool = False, num_samples: int = 256,
                 pos_fraction: float = 0.25,
                 target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2),
                 mask_loss_resolution: str = "full", test_cfg: Any = None):
        super().__init__()
        if mask_loss_resolution not in ("full", "low"):
            raise ValueError(f"mask_loss_resolution={mask_loss_resolution!r}: 'full' or 'low'")
        self.mask_loss_resolution = mask_loss_resolution
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

    def _mask_forward(self, feats, boxes, image_embeddings, image_pe):
        """boxes (B, R, 4) -> (SAM low-res mask logits (B, R, S, S), IoU
        predictions (B, R))."""
        b, r, _ = boxes.shape
        mask_feats = self._roi_feats(feats, boxes, self.mask_roi_size)
        masks, iou = self.mask_head(
            mask_feats.reshape((b, r) + mask_feats.shape[1:]), image_embeddings, image_pe
        )
        s = masks.shape[-1]
        return masks.reshape(b, r, s, s), iou.reshape(b, r)

    def _mask_logits(self, feats, boxes, image_embeddings, image_pe):
        """boxes (B, R, 4) -> SAM low-res mask logits (B, R, S, S)."""
        return self._mask_forward(feats, boxes, image_embeddings, image_pe)[0]

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
        smp, losses = self.sampled_bbox_loss(feats, proposals, proposal_valid, gt_bboxes,
                                             gt_labels, gt_valid, rand)

        # mask branch on the packed positive slots; gradients reach point_emb
        # through the decoder even when the decoder's parameters are frozen
        m = self.num_mask_slots
        pos_mask = smp.is_pos[:, :m] & smp.valid[:, :m]
        mask_logits = self._mask_logits(feats, smp.boxes[:, :m], image_embeddings, image_pe)
        g = gt_masks.shape[1]
        safe_gt = (smp.gt_inds[:, :m] - 1).clamp(0, g - 1)
        targets = take_per_image(gt_masks, safe_gt)
        if self.mask_loss_resolution == "full":
            th, tw = targets.shape[-2:]
            preds = resize(mask_logits, (b, m, th, tw), "bilinear")
        else:
            th, tw = mask_logits.shape[-2:]
            preds = mask_logits
            targets = (resize(targets.float(), (b, m, th, tw), "bilinear") >= 0.5).float()
        losses["loss_mask"] = mask_cross_entropy(
            preds.reshape(b * m, th, tw), targets.reshape(b * m, th, tw),
            valid=pos_mask.reshape(-1),
        )
        return losses

    def tensor(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
               image_embeddings: torch.Tensor, image_pe: torch.Tensor):
        """Raw outputs, no decode or NMS (JAX :190): the bbox head on every
        proposal, the mask branch on the first ``num_mask_slots``. Returns
        (cls_logits (B, N, C+1), bbox_deltas (B, N, 4C), mask_logits (B, M,
        S, S), iou (B, M))."""
        if self.with_extra_pe:
            feats = add_extra_pe(feats, num_feats=feats[0].shape[-1] // 2)
        b, n, _ = proposals.shape
        cls_logits, bbox_deltas = self.bbox_head(
            self._roi_feats(feats, proposals, self.bbox_roi_size))
        m = min(n, self.num_mask_slots)
        masks, iou = self._mask_forward(feats, proposals[:, :m], image_embeddings, image_pe)
        return cls_logits.reshape(b, n, -1), bbox_deltas.reshape(b, n, -1), masks, iou

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
