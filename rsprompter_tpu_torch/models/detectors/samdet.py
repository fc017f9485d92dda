"""SAM-det (torch): a Faster R-CNN detector whose boxes prompt a frozen SAM.

Counterpart of ``rsprompter_tpu/models/detectors/samdet.py`` (reference
``SAMDet``, ``mmdet/rsprompter/models.py:1061-1215``): ResNet + FPN + RPN +
the standard bbox head give at most ``max_per_img`` boxes an image
(``predict``, JAX :129-163), and those boxes are the box prompts of a
complete SAM (``segmentor``, HF names) decoding one mask each
(``multimask_output=False``). The detections ride the decoder's point-batch
axis; padded slots prompt the box [0, 0, 1, 1] (JAX :123) and are masked by
``valid``. ``oracle_predict`` (JAX :176-191) prompts the ground-truth boxes
at score 1 instead: the paper's upper bound for the SAM half.

Both return (DetResult, sigmoid probabilities of the 256^2 full-frame
masks). ``loss`` (JAX :90-117) trains the detector alone: the RPN and bbox
terms of one batch (the samplers' draws as the anchor detector takes them;
``gt_masks`` may be absent), and the segmentor never runs in it (the
optimizer freezes ``segmentor``, ``apis/build.py``). The ResNet's frozen
BatchNorms keep their running statistics and train their scale and bias,
as JAX's do. The model computes in fp32 (the config has no ``bf16``); on
the card the segmentor's encoder blocks run the bf16 kernels
(``models/sam/vision_encoder.py``), and the convolutions run in TF32 or not
as the caller sets ``torch.backends.cudnn.allow_tf32``: the port flips no
global flag.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.backbones.resnet import ARCH_SETTINGS, ResNet
from rsprompter_tpu_torch.models.dense_heads.rpn_head import (
    RPNHead,
    build_rpn_anchor_generator,
    propose,
    two_stage_loss,
)
from rsprompter_tpu_torch.models.detectors.base import ThreeModeDetector
from rsprompter_tpu_torch.models.necks.fpn import FPN
from rsprompter_tpu_torch.models.preprocess import preprocess_images
from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import StandardRoIHead
from rsprompter_tpu_torch.models.sam.configs import (
    SamConfig,
    SamPromptEncoderConfig,
    SamVisionConfig,
    sam_config,
)
from rsprompter_tpu_torch.models.sam.sam import SamModel


def sam_config_for(arch: str, image_size: int,
                   vision_config: Optional[SamVisionConfig] = None) -> SamConfig:
    """The named arch's SAM, or one around a tiny ``vision_config`` (the
    prompt encoder and the decoder at its output width)."""
    if vision_config is None:
        return sam_config(arch, image_size=image_size)
    c = vision_config.output_channels
    vcfg = dataclasses.replace(vision_config, num_pos_feats=c // 2)
    return SamConfig(
        vision_config=vcfg,
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=c, image_size=vcfg.image_size, patch_size=vcfg.patch_size),
        mask_decoder_config=dataclasses.replace(
            sam_config("base").mask_decoder_config, hidden_size=c),
    )


class SAMDet(ThreeModeDetector):
    def __init__(
        self,
        arch: str = "base",
        vision_config: Optional[SamVisionConfig] = None,
        image_size: int = 1024,
        num_classes: int = 1,
        resnet_depth: int = 50,
        rpn_scales: Tuple[float, ...] = (8,),
        rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
        roi_strides: Tuple[int, ...] = (4, 8, 16, 32),
        num_samples: int = 512,
        pos_fraction: float = 0.25,
        train_cfg: Any = None,
        test_cfg: Any = None,
        attn_impl: str = "fused",
    ):
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        expansion = 1 if ARCH_SETTINGS[resnet_depth][0] == "basic" else 4
        self.backbone = ResNet(resnet_depth)
        self.neck = FPN(tuple(64 * expansion * 2 ** i for i in range(4)), 256, 5)
        self.anchor_generator = build_rpn_anchor_generator(
            dict(scales=rpn_scales, strides=rpn_strides))
        self.rpn_head = RPNHead(num_base_priors=self.anchor_generator.num_base_priors)
        self.roi_head = StandardRoIHead(
            num_classes, featmap_strides=roi_strides, with_mask=False, num_samples=num_samples,
            pos_fraction=pos_fraction, test_cfg=self.test_cfg.get("rcnn"))
        self.segmentor = SamModel(sam_config_for(arch, image_size, vision_config), attn_impl)

    def detector_feats(self, images: torch.Tensor):
        """ResNet + FPN: the five feature levels of the detector."""
        return self.neck(self.backbone(preprocess_images(images)))

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The detector's loss terms and ``acc``. batch: images, img_shape,
        gt_bboxes (B, G, 4), gt_labels and gt_valid (B, G); ``draws`` as
        :meth:`RSPrompterAnchor.loss` takes them."""
        return two_stage_loss(self.rpn_head, self.anchor_generator, self.roi_head,
                              self.detector_feats(batch["images"]), batch, self.train_cfg,
                              generator, draws)

    def detect(self, images: torch.Tensor, img_shapes: torch.Tensor) -> DetResult:
        """The detector half: (B, max_per_img) boxes in batch-input pixels."""
        feats = self.detector_feats(images)
        _, _, proposals = propose(self.rpn_head, self.anchor_generator, feats, img_shapes,
                                  self.test_cfg)
        dets, _ = self.roi_head.predict(feats, proposals.boxes, proposals.valid, img_shapes)
        return dets

    @torch.no_grad()
    def tensor(self, batch: Dict[str, torch.Tensor]):
        """``mode='tensor'`` of the detector half (JAX :148; the segmentor
        has no raw path): per-level RPN scores and deltas, then the bbox
        head's logits and deltas on the NMS'd proposals."""
        feats = self.detector_feats(batch["images"])
        cls_scores, bbox_preds, proposals = propose(
            self.rpn_head, self.anchor_generator, feats, batch["img_shape"], self.test_cfg)
        return (tuple(cls_scores), tuple(bbox_preds)) + self.roi_head.tensor(
            feats, proposals.boxes)

    def decode_masks(self, images: torch.Tensor, boxes: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
        """Box prompts (B, N, 4) -> SAM mask probabilities (B, N, 4h, 4w) fp32."""
        safe = torch.where(valid[..., None], boxes, boxes.new_tensor([0.0, 0.0, 1.0, 1.0]))
        masks, _ = self.segmentor(pixel_values=preprocess_images(images), input_boxes=safe,
                                  multimask_output=False)
        return torch.sigmoid(masks[:, :, 0].float())

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images (B, H, W, 3) uint8 BGR (or normalised float) and
        img_shape (B, 2). Returns (DetResult, mask probs (B, N, 4h, 4w))."""
        dets = self.detect(batch["images"], batch["img_shape"])
        return dets, self.decode_masks(batch["images"], dets.boxes, dets.valid)

    @torch.no_grad()
    def oracle_predict(self, batch: Dict[str, torch.Tensor]):
        """batch: images and the ground truth in batch-input pixels,
        gt_bboxes (B, G, 4), gt_labels and gt_valid (B, G). The GT boxes are
        the detections, at score 1 where valid."""
        boxes, valid = batch["gt_bboxes"], batch["gt_valid"]
        dets = DetResult(boxes, valid.float(), batch["gt_labels"].long(), valid)
        return dets, self.decode_masks(batch["images"], boxes, valid)
