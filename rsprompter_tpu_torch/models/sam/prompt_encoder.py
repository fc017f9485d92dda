"""SAM's prompt encoder (torch, NHWC).

Counterpart of ``rsprompter_tpu/models/sam/prompt_encoder.py`` (HF
``SamPromptEncoder``, names included: ``shared_embedding``,
``point_embed.0-3``, ``not_a_point_embed``, ``no_mask_embed``,
``mask_embed``). SAM-det's segmentor embeds its box prompts with it; the
query head's ``decoder_plus`` path turns each query's mask logits into a
dense prompt with ``SamMaskEmbedding`` alone.

Points and boxes are pixel coordinates of the ``image_size`` input, shifted
to pixel centres (+0.5). Point labels: 1 foreground, 0 background, -1
not-a-point (``not_a_point_embed``), -10 padding (zero); points without
boxes get one not-a-point appended. A box embeds its two corners, each with
its own ``point_embed`` (2, 3). The dense prompt is the mask embedding of
``input_masks``, else ``no_mask_embed`` on every position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import Conv2d, SamLayerNorm
from rsprompter_tpu_torch.models.sam.configs import SamPromptEncoderConfig
from rsprompter_tpu_torch.models.sam.positional import SamPositionalEmbedding


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


class SamPromptEncoder(nn.Module):
    def __init__(self, config: SamPromptEncoderConfig):
        super().__init__()
        c = config.hidden_size
        self.config = config
        self.shared_embedding = SamPositionalEmbedding(c // 2, scale=c // 2)
        self.mask_embed = SamMaskEmbedding(config)
        self.no_mask_embed = nn.Embedding(1, c)
        self.not_a_point_embed = nn.Embedding(1, c)
        self.point_embed = nn.ModuleList(
            nn.Embedding(1, c) for _ in range(config.num_point_embeddings))

    def _pe(self, coords: torch.Tensor) -> torch.Tensor:
        size = self.config.image_size
        return self.shared_embedding(coords, input_shape=(size, size))

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool):
        """points (B, P, N, 2), labels (B, P, N) -> (B, P, N (+1), C)."""
        points = points + 0.5
        if pad:
            b, p = points.shape[:2]
            points = torch.cat([points, points.new_zeros((b, p, 1, 2))], dim=2)
            labels = torch.cat([labels, labels.new_full((b, p, 1), -1)], dim=2)
        pe = self._pe(points)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        pe = torch.where(lab == -10, 0.0, pe)
        pe = torch.where(lab == 0, pe + self.point_embed[0].weight[0], pe)
        return torch.where(lab == 1, pe + self.point_embed[1].weight[0], pe)

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (B, N, 4) xyxy -> (B, N, 2, C)."""
        b, n = boxes.shape[:2]
        corners = self._pe((boxes + 0.5).reshape(b, n, 2, 2))
        return corners + torch.stack([self.point_embed[2].weight[0],
                                      self.point_embed[3].weight[0]])

    def forward(
        self,
        input_points: Optional[torch.Tensor] = None,
        input_labels: Optional[torch.Tensor] = None,
        input_boxes: Optional[torch.Tensor] = None,
        input_masks: Optional[torch.Tensor] = None,
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """-> (sparse (B, P, T, C) or None, dense (B, h, w, C))."""
        sparse = None
        batch_size = 1
        if input_points is not None:
            if input_labels is None:
                raise ValueError("labels required with points")
            batch_size = input_points.shape[0]
            sparse = self._embed_points(input_points, input_labels, pad=input_boxes is None)
        if input_boxes is not None:
            batch_size = input_boxes.shape[0]
            box_emb = self._embed_boxes(input_boxes)
            sparse = box_emb if sparse is None else torch.cat([sparse, box_emb], dim=2)
        if input_masks is not None:
            return sparse, self.mask_embed(input_masks)
        size = self.config.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1)
        return sparse, dense.expand(batch_size, size, size, -1)
