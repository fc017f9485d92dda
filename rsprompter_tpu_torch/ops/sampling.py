"""Bilinear grid sampling (plain torch).

Counterpart of ``rsprompter_tpu/ops/sampling.py``: ``F.grid_sample``
semantics with ``padding_mode='zeros'`` (a corner outside the map reads 0),
on NHWC maps. JAX weighs bf16 values with fp32 weights and sums in fp32, so
this samples in fp32 whatever the map's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_nhwc(img: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """img (B, H, W, C); grid (B, P, 2) in [-1, 1], (x, y) order -> (B, P, C) fp32."""
    out = F.grid_sample(
        img.float().permute(0, 3, 1, 2), grid.float()[:, :, None, :], mode="bilinear",
        padding_mode="zeros", align_corners=align_corners,
    )  # (B, C, P, 1)
    return out[..., 0].transpose(1, 2)
