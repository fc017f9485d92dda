"""RSPrompter anchor-variant detector (torch): loss and predict.

Counterpart of ``rsprompter_tpu/models/detectors/rsprompter_anchor.py``: SAM
ViT encoder (with the qkv LoRA adapters where ``lora_rank > 0``) -> (RS
aggregator over the hidden states, or the pseudo aggregator over the image
embeddings alone with ``aggregator_type='pseudo'`` (:146-149), + simple FPN
features, image embeddings, image-wide Fourier PE) -> RPN -> RoI prompt head
with the SAM mask decoder. Attribute names mirror the JAX module's
parameter tree.

``loss`` (:164) returns the RPN, bbox and mask losses of one batch: with
``freeze_backbone`` the encoder runs without gradient (JAX's stop-gradient on
every encoder output, :139-143; the peft configs leave it off, so the
gradient reaches the adapters and the optimizer's groups freeze the rest);
proposals come from the detached RPN outputs (:180-181); the RPN and RoI
samplers draw from one generator (JAX's two RNG streams), or take explicit
draws. The module's train / eval mode is
the BatchNorms' (batch statistics in ``loss``, as JAX's ``train=True``).
``forward(batch, mode)`` dispatches to ``loss``, ``predict`` or ``tensor``
(JAX :211: the raw outputs).
"""

from __future__ import annotations

import dataclasses
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
from rsprompter_tpu_torch.models.roi_heads.prompt_roi_head import RSPrompterAnchorRoIPromptHead
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig, sam_config
from rsprompter_tpu_torch.models.sam.positional import (
    SamPositionalEmbedding,
    image_wide_positional_embeddings,
)
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder


class RSPrompterAnchor(ThreeModeDetector):
    def __init__(
        self,
        arch: str = "base",
        vision_config: Optional[SamVisionConfig] = None,
        image_size: int = 1024,
        num_classes: int = 1,
        prompt_shape: Tuple[int, int] = (100, 5),
        select_layers: Tuple[int, ...] = tuple(range(1, 13, 2)),
        aggregator_type: str = "multi",
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
        attn_impl: str = "fused",
        lora_rank: int = 0,
        lora_alpha: float = 32.0,
        mask_loss_resolution: str = "full",
    ):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.train_cfg = dict(train_cfg or {})
        vcfg = vision_config or sam_config(arch, image_size=image_size).vision_config
        decoder_cfg = sam_config("base").mask_decoder_config
        if vcfg.output_channels != decoder_cfg.hidden_size:
            decoder_cfg = dataclasses.replace(decoder_cfg, hidden_size=vcfg.output_channels)
        self.test_cfg = dict(test_cfg or {})
        self.backbone = SamVisionEncoder(vcfg, attn_impl, lora_rank, lora_alpha)
        self.shared_image_embedding = SamPositionalEmbedding(
            vcfg.output_channels // 2, scale=vcfg.output_channels // 2
        )
        self.aggregator_type = aggregator_type
        self.neck_feature_aggregator = build_aggregator(
            aggregator_type, vcfg, aggregator_hidden, select_layers
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
            mask_loss_resolution=mask_loss_resolution, test_cfg=self.test_cfg.get("rcnn"),
        )

    def extract_feat(self, images: torch.Tensor):
        images = preprocess_images(images)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            image_embeddings, hidden_states = self.backbone(images)
        image_pe = image_wide_positional_embeddings(
            self.shared_image_embedding, image_embeddings.shape[1]
        )
        neck_in = (image_embeddings,) if self.aggregator_type == "pseudo" else hidden_states
        feats = self.neck_feature_spliter(self.neck_feature_aggregator(neck_in))
        return feats, image_embeddings, image_pe

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """batch: images, img_shape, gt_bboxes (B, G, 4), gt_labels, gt_valid
        (B, G) and gt_masks (B, G, H, W). ``draws`` {'rpn': (3, B, P),
        'roi': (3, B, G + N)} are the samplers' uniforms; without them they
        come from ``generator``. Returns the loss terms and ``acc``."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        return two_stage_loss(self.rpn_head, self.anchor_generator, self.roi_head, feats, batch,
                              self.train_cfg, generator, draws, image_embeddings, image_pe)

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images (B, H, W, 3) uint8 BGR (or normalised float) and
        img_shape (B, 2). Returns (DetResult, mask probs (B, N, S, S) fp32)."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        _, _, proposals = propose(self.rpn_head, self.anchor_generator, feats,
                                  batch["img_shape"], self.test_cfg)
        return self.roi_head.predict(
            feats, proposals.boxes, proposals.valid, batch["img_shape"],
            image_embeddings, image_pe,
        )

    @torch.no_grad()
    def tensor(self, batch: Dict[str, torch.Tensor]):
        """``mode='tensor'`` (JAX :211): the per-level RPN scores (B, h, w,
        A) and deltas (B, h, w, 4A), then the RoI head's raw outputs on the
        NMS'd proposals (``RSPrompterAnchorRoIPromptHead.tensor``); no
        decode, threshold or postprocess."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        cls_scores, bbox_preds, proposals = propose(
            self.rpn_head, self.anchor_generator, feats, batch["img_shape"], self.test_cfg)
        return (tuple(cls_scores), tuple(bbox_preds)) + self.roi_head.tensor(
            feats, proposals.boxes, image_embeddings, image_pe)
