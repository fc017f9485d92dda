"""SAM's mask-prompt embedding (torch, NHWC).

Counterpart of ``SamMaskEmbedding`` in ``rsprompter_tpu/models/sam/prompt_encoder.py``
(HF ``SamMaskEmbedding``): the query head's ``decoder_plus`` path turns each
query's mask logits into a dense prompt with it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import Conv2d, SamLayerNorm
from rsprompter_tpu_torch.models.sam.configs import SamPromptEncoderConfig


class SamMaskEmbedding(nn.Module):
    """2x2 stride-2 conv -> LN -> GELU, twice, then a 1x1 conv to the hidden size."""

    def __init__(self, config: SamPromptEncoderConfig):
        super().__init__()
        ch = config.mask_input_channels
        eps = config.layer_norm_eps
        self.conv1 = Conv2d(1, ch // 4, 2, stride=2)
        self.layer_norm1 = SamLayerNorm(ch // 4, eps)
        self.conv2 = Conv2d(ch // 4, ch, 2, stride=2)
        self.layer_norm2 = SamLayerNorm(ch, eps)
        self.conv3 = Conv2d(ch, config.hidden_size, 1)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (B, H, W, 1) at 4x the embedding resolution -> (B, H/4, W/4, C)."""
        x = F.gelu(self.layer_norm1(self.conv1(masks)))
        x = F.gelu(self.layer_norm2(self.conv2(x)))
        return self.conv3(x)
