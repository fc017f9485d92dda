"""The complete SAM (image encoder + prompt encoder + mask decoder), torch.

Counterpart of ``rsprompter_tpu/models/sam/sam.py`` (HF ``SamModel``, :30-96),
SAM-det's frozen segmentor. The four children keep HF's top-level names, so
an HF SAM state_dict maps one to one under the detector's ``segmentor.``
prefix. The prompts of one image ride the decoder's point-batch axis (SAM-det:
its detections, one box each).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.sam.configs import SamConfig
from rsprompter_tpu_torch.models.sam.mask_decoder import SamMaskDecoder
from rsprompter_tpu_torch.models.sam.positional import (
    SamPositionalEmbedding,
    image_wide_positional_embeddings,
)
from rsprompter_tpu_torch.models.sam.prompt_encoder import SamPromptEncoder
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder


class SamModel(nn.Module):
    def __init__(self, config: SamConfig, attn_impl: str = "fused"):
        super().__init__()
        self.config = config
        self.shared_image_embedding = SamPositionalEmbedding(
            config.vision_config.num_pos_feats,
            scale=config.prompt_encoder_config.hidden_size // 2,
        )
        self.vision_encoder = SamVisionEncoder(config.vision_config, attn_impl)
        self.prompt_encoder = SamPromptEncoder(config.prompt_encoder_config)
        self.mask_decoder = SamMaskDecoder(config.mask_decoder_config)

    def forward(
        self,
        pixel_values: Optional[torch.Tensor] = None,
        input_points: Optional[torch.Tensor] = None,
        input_labels: Optional[torch.Tensor] = None,
        input_boxes: Optional[torch.Tensor] = None,
        input_masks: Optional[torch.Tensor] = None,
        image_embeddings: Optional[torch.Tensor] = None,
        multimask_output: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalised NHWC ``pixel_values`` (or the encoder's
        ``image_embeddings``) and the prompts -> (masks (B, P, M, 4h, 4w),
        IoU (B, P, M)); M is 3 with ``multimask_output``, else 1."""
        if (pixel_values is None) == (image_embeddings is None):
            raise ValueError("Provide exactly one of pixel_values / image_embeddings")
        if pixel_values is not None:
            image_embeddings, _ = self.vision_encoder(pixel_values)
        b = image_embeddings.shape[0]
        size = self.config.prompt_encoder_config.image_embedding_size
        image_pe = image_wide_positional_embeddings(self.shared_image_embedding, size)
        if input_points is not None and input_labels is None:
            input_labels = torch.ones(input_points.shape[:-1], dtype=torch.int32,
                                      device=input_points.device)
        sparse, dense = self.prompt_encoder(input_points, input_labels, input_boxes,
                                            input_masks)
        return self.mask_decoder(image_embeddings, image_pe.expand(b, -1, -1, -1), sparse,
                                 dense, multimask_output=multimask_output)
