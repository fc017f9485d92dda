"""SAM-seg Mask R-CNN (torch): the SAM encoder under a Mask R-CNN.

Counterpart of ``SAMSegMaskRCNN`` in
``rsprompter_tpu/models/detectors/two_stage.py`` (reference
``mmdet/rsprompter/models.py:1219-1244``): the SAM ViT encoder (with the qkv
LoRA adapters where ``lora_rank > 0``) -> the RS aggregator over its hidden
states (or the pseudo aggregator over its image embeddings,
``aggregator_type='pseudo'``) + simple FPN -> RPN -> ``StandardRoIHead``
with the FCN mask head. ``predict`` (JAX :160-175) returns the detections and
each one's 28^2 mask probabilities; they are pasted into their boxes on the
host (``roi_heads.mask_head.paste_masks_np``; the metric's and the
inferencer's ``paste`` mode). ``loss`` (JAX :134-160) returns the RPN, bbox
and FCN mask losses of one batch, the encoder without gradient where
``freeze_backbone`` is set (JAX's stop-gradient; with LoRA it runs under
autograd and the optimizer trains its adapters alone), the samplers' draws
as the anchor detector takes them. Attribute names mirror the JAX module's
parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from rsprompter_tpu_torch.models.dense_heads.rpn_head import (
    RPNHead,
    build_rpn_anchor_generator,
    propose,
    two_stage_loss,
)
from rsprompter_tpu_torch.models.detectors.base import ThreeModeDetector
from rsprompter_tpu_torch.models.necks.rsfpn import RSSimpleFPN, build_aggregator
from rsprompter_tpu_torch.models.preprocess import preprocess_images
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import StandardRoIHead
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig, sam_config
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder


class SAMSegMaskRCNN(ThreeModeDetector):
    mask_mode = "paste"  # its masks are RoI maps over their boxes

    def __init__(
        self,
        arch: str = "base",
        vision_config: Optional[SamVisionConfig] = None,
        image_size: int = 1024,
        num_classes: int = 1,
        select_layers: Tuple[int, ...] = tuple(range(1, 13, 2)),
        aggregator_type: str = "multi",
        aggregator_hidden: int = 32,
        rpn_scales: Tuple[float, ...] = (8,),
        rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
        roi_strides: Tuple[int, ...] = (4, 8, 16, 32),
        num_samples: int = 512,
        pos_fraction: float = 0.25,
        freeze_backbone: bool = True,
        train_cfg: Any = None,
        test_cfg: Any = None,
        attn_impl: str = "fused",
        lora_rank: int = 0,
        lora_alpha: float = 32.0,
    ):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        vcfg = vision_config or sam_config(arch, image_size=image_size).vision_config
        self.backbone = SamVisionEncoder(vcfg, attn_impl, lora_rank, lora_alpha)
        self.aggregator_type = aggregator_type
        self.neck_feature_aggregator = build_aggregator(
            aggregator_type, vcfg, aggregator_hidden, select_layers)
        self.neck_feature_spliter = RSSimpleFPN(backbone_channel=256)
        self.anchor_generator = build_rpn_anchor_generator(
            dict(scales=rpn_scales, strides=rpn_strides))
        self.rpn_head = RPNHead(num_base_priors=self.anchor_generator.num_base_priors)
        self.roi_head = StandardRoIHead(
            num_classes, featmap_strides=roi_strides, num_samples=num_samples,
            pos_fraction=pos_fraction, test_cfg=self.test_cfg.get("rcnn"))

    def extract_feat(self, images: torch.Tensor):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            image_embeddings, hidden_states = self.backbone(preprocess_images(images))
        neck_in = (image_embeddings,) if self.aggregator_type == "pseudo" else hidden_states
        return self.neck_feature_spliter(self.neck_feature_aggregator(neck_in))

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """batch: images, img_shape, gt_bboxes (B, G, 4), gt_labels, gt_valid
        (B, G) and gt_masks (B, G, H, W) 0 / 1. ``draws`` {'rpn': (3, B, P),
        'roi': (3, B, G + N)} are the samplers' uniforms; without them they
        come from ``generator``. Returns the loss terms and ``acc``."""
        return two_stage_loss(self.rpn_head, self.anchor_generator, self.roi_head,
                              self.extract_feat(batch["images"]), batch, self.train_cfg,
                              generator, draws)

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images (B, H, W, 3) uint8 BGR (or normalised float) and
        img_shape (B, 2). Returns (DetResult, mask probs (B, N, 28, 28) fp32,
        each over its detection's box)."""
        feats = self.extract_feat(batch["images"])
        _, _, proposals = propose(self.rpn_head, self.anchor_generator, feats,
                                  batch["img_shape"], self.test_cfg)
        return self.roi_head.predict(feats, proposals.boxes, proposals.valid,
                                     batch["img_shape"])

    @torch.no_grad()
    def tensor(self, batch: Dict[str, torch.Tensor]):
        """``mode='tensor'`` (JAX :176): per-level RPN scores and deltas,
        then ``StandardRoIHead.tensor`` on the NMS'd proposals."""
        feats = self.extract_feat(batch["images"])
        cls_scores, bbox_preds, proposals = propose(
            self.rpn_head, self.anchor_generator, feats, batch["img_shape"], self.test_cfg)
        return (tuple(cls_scores), tuple(bbox_preds)) + self.roi_head.tensor(
            feats, proposals.boxes)
