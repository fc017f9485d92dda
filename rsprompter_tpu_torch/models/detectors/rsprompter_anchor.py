"""RSPrompter anchor-variant detector (torch): loss and predict.

Counterpart of ``rsprompter_tpu/models/detectors/rsprompter_anchor.py``: SAM
ViT encoder -> (RS aggregator + simple FPN features, image embeddings,
image-wide Fourier PE) -> RPN -> RoI prompt head with the SAM mask decoder.
Attribute names mirror the JAX module's parameter tree.

``loss`` (:164) returns the RPN, bbox and mask losses of one batch: with
``freeze_backbone`` the encoder runs without gradient (JAX's stop-gradient on
every encoder output, :139-143); proposals come from the detached RPN
outputs (:180-181); the RPN and RoI samplers draw from one generator (JAX's
two RNG streams), or take explicit draws. The module's train / eval mode is
the BatchNorms' (batch statistics in ``loss``, as JAX's ``train=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.dense_heads.rpn_head import (
    RPNHead,
    build_rpn_anchor_generator,
    rpn_loss,
    rpn_predict,
)
from rsprompter_tpu_torch.models.necks.rsfpn import RSFeatureAggregator, RSSimpleFPN
from rsprompter_tpu_torch.models.preprocess import preprocess_images
from rsprompter_tpu_torch.models.roi_heads.prompt_roi_head import RSPrompterAnchorRoIPromptHead
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig, sam_config
from rsprompter_tpu_torch.models.sam.positional import (
    SamPositionalEmbedding,
    image_wide_positional_embeddings,
)
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder


class RSPrompterAnchor(nn.Module):
    def __init__(
        self,
        arch: str = "base",
        vision_config: Optional[SamVisionConfig] = None,
        image_size: int = 1024,
        num_classes: int = 1,
        prompt_shape: Tuple[int, int] = (100, 5),
        select_layers: Tuple[int, ...] = tuple(range(1, 13, 2)),
        aggregator_hidden: int = 32,
        rpn_scales: Tuple[float, ...] = (4, 8),
        rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
        roi_strides: Tuple[int, ...] = (4, 8, 16, 32),
        with_extra_pe: bool = True,
        with_sincos: bool = True,
        multimask_output: bool = False,
        num_samples: int = 256,
        pos_fraction: float = 0.25,
        freeze_backbone: bool = True,
        train_cfg: Any = None,
        test_cfg: Any = None,
    ):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.train_cfg = dict(train_cfg or {})
        self._anchors = {}  # (feature-map sizes, device) -> uploaded anchors
        vcfg = vision_config or sam_config(arch, image_size=image_size).vision_config
        decoder_cfg = sam_config("base").mask_decoder_config
        if vcfg.output_channels != decoder_cfg.hidden_size:
            decoder_cfg = dataclasses.replace(decoder_cfg, hidden_size=vcfg.output_channels)
        self.test_cfg = dict(test_cfg or {})
        self.backbone = SamVisionEncoder(vcfg)
        self.shared_image_embedding = SamPositionalEmbedding(
            vcfg.output_channels // 2, scale=vcfg.output_channels // 2
        )
        self.neck_feature_aggregator = RSFeatureAggregator(
            vcfg.hidden_size, aggregator_hidden, 256, select_layers, vcfg.num_hidden_layers
        )
        self.neck_feature_spliter = RSSimpleFPN(backbone_channel=256)
        self.anchor_generator = build_rpn_anchor_generator(
            dict(scales=rpn_scales, strides=rpn_strides)
        )
        self.rpn_head = RPNHead(num_base_priors=self.anchor_generator.num_base_priors)
        self.roi_head = RSPrompterAnchorRoIPromptHead(
            decoder_cfg, num_classes=num_classes, featmap_strides=roi_strides,
            with_extra_pe=with_extra_pe, per_pointset_point=prompt_shape[1],
            with_sincos=with_sincos, multimask_output=multimask_output,
            num_samples=num_samples, pos_fraction=pos_fraction,
            test_cfg=self.test_cfg.get("rcnn"),
        )

    def extract_feat(self, images: torch.Tensor):
        images = preprocess_images(images)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            image_embeddings, hidden_states = self.backbone(images)
        image_pe = image_wide_positional_embeddings(
            self.shared_image_embedding, image_embeddings.shape[1]
        )
        feats = self.neck_feature_spliter(self.neck_feature_aggregator(hidden_states))
        return feats, image_embeddings, image_pe

    def level_anchors(self, feats):
        """Per-level anchors on the features' device, built and uploaded once
        per feature-map shape."""
        sizes = tuple(tuple(f.shape[1:3]) for f in feats)
        key = (sizes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                torch.as_tensor(a, device=feats[0].device)
                for a in self.anchor_generator.grid_anchors(sizes)
            ]
        return self._anchors[key]

    def _rpn_cfgs(self):
        rpn_train = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3, num=256,
                         pos_fraction=0.5)
        rpn_train.update(self.train_cfg.get("rpn", {}))
        rpn_proposal = dict(nms_pre=2000, max_per_img=1000, nms_iou_thr=0.7)
        rpn_proposal.update(self.train_cfg.get("rpn_proposal", {}))
        return rpn_train, rpn_proposal

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """batch: images, img_shape, gt_bboxes (B, G, 4), gt_labels, gt_valid
        (B, G) and gt_masks (B, G, H, W). ``draws`` {'rpn': (3, B, P),
        'roi': (3, B, G + N)} are the samplers' uniforms; without them they
        come from ``generator``. Returns the loss terms and ``acc``."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        cls_scores, bbox_preds = self.rpn_head(feats)
        level_anchors = self.level_anchors(feats)
        anchors = torch.cat(level_anchors, dim=0)
        rpn_train_cfg, rpn_proposal_cfg = self._rpn_cfgs()
        gt_bboxes, gt_valid = batch["gt_bboxes"], batch["gt_valid"]
        b, g = gt_valid.shape

        def draw(name, n):
            if draws is not None:
                return draws[name]
            return torch.rand((3, b, n), generator=generator, device=anchors.device)

        losses = rpn_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_valid,
                          draw("rpn", anchors.shape[0]), rpn_train_cfg)
        proposals = rpn_predict(
            [s.detach() for s in cls_scores], [d.detach() for d in bbox_preds],
            level_anchors, batch["img_shape"], rpn_proposal_cfg,
        )
        losses.update(self.roi_head.loss(
            feats, proposals.boxes, proposals.valid, gt_bboxes, batch["gt_labels"],
            gt_valid, batch["gt_masks"], image_embeddings, image_pe,
            draw("roi", g + proposals.boxes.shape[1]),
        ))
        return losses

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images (B, H, W, 3) uint8 BGR (or normalised float) and
        img_shape (B, 2). Returns (DetResult, mask probs (B, N, S, S) fp32)."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        cls_scores, bbox_preds = self.rpn_head(feats)
        level_anchors = self.level_anchors(feats)
        rpn_cfg = dict(nms_pre=1000, max_per_img=1000, nms_iou_thr=0.7)
        rpn_cfg.update(self.test_cfg.get("rpn", {}))
        proposals = rpn_predict(
            cls_scores, bbox_preds, level_anchors, batch["img_shape"], rpn_cfg
        )
        return self.roi_head.predict(
            feats, proposals.boxes, proposals.valid, batch["img_shape"],
            image_embeddings, image_pe,
        )
