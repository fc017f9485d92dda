"""RSPrompter query-variant detector (torch): loss and predict.

Counterpart of ``rsprompter_tpu/models/detectors/rsprompter_query.py``
(reference ``RSPrompterQuery``, ``mmdet/rsprompter/models.py:174-272``): SAM
ViT encoder (with the qkv LoRA adapters where ``lora_rank > 0``) -> the
multi-layer RS aggregator over its hidden states, or with
``aggregator_type='pseudo'`` the pseudo aggregator over the image
embeddings alone (JAX :139), + simple FPN features, image embeddings and
the image-wide Fourier PE -> the Mask2Former query head prompting the SAM
mask decoder -> the fusion head's top-k instances. Attribute names mirror
the JAX module's parameter tree.

``loss`` (JAX :144) returns the head's 35 loss terms for one batch (21
with ``decoder_plus=False``, whose head has no plus stream): with
``freeze_backbone`` the encoder runs without gradient (JAX's stop-gradient
on its outputs; the peft configs leave it off, so the gradient reaches the
adapters and the optimizer's groups freeze the rest); the head's point
draws come from one generator, or are given (``draws``, as the anchor's
``loss`` takes them). The module's train /
eval mode is the neck's BatchNorms' (batch statistics in ``loss``).
``forward(batch, mode)`` dispatches to ``loss``, ``predict`` or ``tensor``
(JAX :180: every head call's raw logits).

``SAMSegMask2Former`` (JAX :195-199, reference ``models.py:1248``) is the
same pipeline with the stock Mask2Former head (``sam_prompting=False``):
no SAM decoder, no shared positional embedding; its masks are the head's
mask-feature products at a quarter of the input's resolution, and its loss
the head's 21 terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from rsprompter_tpu_torch.models.dense_heads.mask2former_head import Mask2FormerHead
from rsprompter_tpu_torch.models.detectors.base import ThreeModeDetector
from rsprompter_tpu_torch.models.necks.rsfpn import RSSimpleFPN, build_aggregator
from rsprompter_tpu_torch.models.preprocess import preprocess_images
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig, sam_config
from rsprompter_tpu_torch.models.sam.positional import (
    SamPositionalEmbedding,
    image_wide_positional_embeddings,
)
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.models.seg_heads.fusion_head import instance_postprocess
from rsprompter_tpu_torch.parallel.distributed import local_rows, world_size


class RSPrompterQuery(ThreeModeDetector):
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
        with_sincos: bool = True,
        freeze_backbone: bool = True,
        train_cfg: Any = None,
        test_cfg: Any = None,
        attn_impl: str = "fused",
        lora_rank: int = 0,
        lora_alpha: float = 32.0,
        sam_prompting: bool = True,
        decoder_plus: bool = True,
    ):
        super().__init__()
        self.sam_prompting = sam_prompting
        self.num_classes = num_classes
        self.freeze_backbone = freeze_backbone
        tc = dict(train_cfg or {})
        self.max_per_image = dict(test_cfg or {}).get("max_per_image", 100)
        vcfg = vision_config or sam_config(arch, image_size=image_size).vision_config
        decoder_cfg = sam_config("base").mask_decoder_config
        if vcfg.output_channels != decoder_cfg.hidden_size:
            decoder_cfg = dataclasses.replace(decoder_cfg, hidden_size=vcfg.output_channels)
        self.backbone = SamVisionEncoder(vcfg, attn_impl, lora_rank, lora_alpha)
        if sam_prompting:
            self.shared_image_embedding = SamPositionalEmbedding(
                vcfg.output_channels // 2, scale=vcfg.output_channels // 2
            )
        self.aggregator_type = aggregator_type
        self.neck_feature_aggregator = build_aggregator(
            aggregator_type, vcfg, aggregator_hidden, select_layers
        )
        self.neck_feature_spliter = RSSimpleFPN(backbone_channel=256)
        self.panoptic_head = Mask2FormerHead(
            decoder_cfg, num_classes=num_classes, num_queries=prompt_shape[0],
            out_channels=vcfg.output_channels, per_pointset_point=prompt_shape[1],
            with_sincos=with_sincos, num_points=tc.get("num_points", 12544),
            oversample_ratio=tc.get("oversample_ratio", 3.0),
            importance_sample_ratio=tc.get("importance_sample_ratio", 0.75),
            sam_prompting=sam_prompting, decoder_plus=decoder_plus,
        )

    def extract_feat(self, images: torch.Tensor):
        images = preprocess_images(images)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            image_embeddings, hidden_states = self.backbone(images)
        image_pe = None
        if self.sam_prompting:
            image_pe = image_wide_positional_embeddings(
                self.shared_image_embedding, image_embeddings.shape[1]
            )
        neck_in = (image_embeddings,) if self.aggregator_type == "pseudo" else hidden_states
        feats = self.neck_feature_spliter(self.neck_feature_aggregator(neck_in))
        return feats, image_embeddings, image_pe

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """batch: images, gt_labels, gt_valid (B, G) and gt_masks (B, G, H, W)
        at the batch input's resolution. ``draws`` (the head's
        ``draw_shapes`` for the global batch: this batch at world 1) are the
        point samplers' uniforms; without them they come from ``generator``,
        which every rank seeds alike. Each rank keeps its own rows."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        head = self.panoptic_head
        b, g = batch["gt_valid"].shape
        if draws is None:
            draws = {k: torch.rand(shape, generator=generator, device=image_embeddings.device)
                     for k, shape in head.draw_shapes(world_size() * b, g).items()}
        local = head.draw_shapes(b, g)
        draws = {k: local_rows(v, 1, local[k][1]) for k, v in draws.items()}
        return head.loss(feats, batch["gt_labels"], batch["gt_masks"], batch["gt_valid"],
                         image_embeddings, image_pe, draws)

    @torch.no_grad()
    def predict_logits(self, batch: Dict[str, torch.Tensor]):
        """The last decoder layer's (class logits (B, Q, C+1), mask logits
        (B, Q, 4h, 4w) fp32), before the fusion head's top-k."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        return self.panoptic_head.predict(feats, image_embeddings, image_pe)

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images (B, H, W, 3) uint8 BGR (or normalised float).
        Returns (DetResult in batch-input pixels, mask probs (B, k, 4h, 4w))."""
        cls_pred, mask_pred = self.predict_logits(batch)
        scale = batch["images"].shape[1] / mask_pred.shape[-2]
        return instance_postprocess(cls_pred, mask_pred, self.num_classes,
                                    self.max_per_image, scale_boxes=scale)

    @torch.no_grad()
    def tensor(self, batch: Dict[str, torch.Tensor]):
        """``mode='tensor'`` (JAX :180-192): every head call's raw class
        logits (B, Q, C+1) and mask logits, one entry per decoder layer and
        one before the first, no fusion-head postprocess. The masks are each
        call's SAM decode of every query (B, Q, 4h, 4w), or the stock head's
        mask-feature products (B, Q, H/4, W/4). Returns (cls tuple, mask
        tuple)."""
        feats, image_embeddings, image_pe = self.extract_feat(batch["images"])
        head = self.panoptic_head
        if self.sam_prompting:
            cls_list, mask_list = head(feats, image_embeddings, image_pe)
        else:
            cls_list, _, mask_list = head.run_decoder(feats)
        return tuple(cls_list), tuple(mask_list)


class SAMSegMask2Former(RSPrompterQuery):
    """The stock Mask2Former head on SAM features."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs, sam_prompting=False)
