"""SAM random-Fourier positional embedding.

Counterpart of ``rsprompter_tpu/models/sam/positional.py`` (HF
``SamPositionalEmbedding``): coords in [0, 1] -> 2c - 1 -> c @ W -> 2 pi c ->
[sin, cos]. The (2, num_pos_feats) projection is a parameter, as in the JAX
module: it trains when the decoder does (``decoder_freeze=False``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class SamPositionalEmbedding(nn.Module):
    def __init__(self, num_pos_feats: int = 128, scale: float = 128.0):
        super().__init__()
        self.positional_embedding = nn.Parameter(scale * torch.randn(2, num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords (..., 2) in [0, 1] -> (..., 2 * num_pos_feats) fp32."""
        c = 2.0 * coords.float() - 1.0
        proj = 2.0 * math.pi * (c @ self.positional_embedding.float())
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def image_wide_positional_embeddings(pe: SamPositionalEmbedding, size: int) -> torch.Tensor:
    """Dense PE grid (1, size, size, C) from pixel-centre coords."""
    dev = pe.positional_embedding.device
    grid = torch.ones((size, size), dtype=torch.float32, device=dev)
    y_embed = (torch.cumsum(grid, dim=0) - 0.5) / size
    x_embed = (torch.cumsum(grid, dim=1) - 0.5) / size
    return pe(torch.stack([x_embed, y_embed], dim=-1))[None]
