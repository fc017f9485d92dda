"""Multi-scale deformable attention core (plain torch).

Counterpart of ``rsprompter_tpu/ops/msdeform_attn.py`` (mmcv
``MultiScaleDeformableAttention``): per query, ``P`` sampling points per head
per level, bilinearly sampled from that level's value map and summed with
their softmaxed weights, in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rsprompter_tpu_torch.ops.sampling import grid_sample_nhwc


def ms_deform_attn_core(
    value_levels: Sequence[torch.Tensor],  # per level (B, H_l, W_l, heads, hd)
    sampling_locations: torch.Tensor,  # (B, Q, heads, L, P, 2) in [0, 1], (x, y)
    attention_weights: torch.Tensor,  # (B, Q, heads, L, P), softmaxed
) -> torch.Tensor:
    """Returns (B, Q, heads * hd) fp32."""
    b, q, nh, _, npt, _ = sampling_locations.shape
    hd = value_levels[0].shape[-1]
    out = None
    for lvl, val in enumerate(value_levels):
        v = val.permute(0, 3, 1, 2, 4).reshape(b * nh, val.shape[1], val.shape[2], hd)
        grid = 2.0 * sampling_locations[:, :, :, lvl] - 1.0  # (B, Q, heads, P, 2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * nh, q * npt, 2)
        sampled = grid_sample_nhwc(v, grid).reshape(b, nh, q, npt, hd)
        w = attention_weights[:, :, :, lvl].permute(0, 2, 1, 3).float()  # (B, heads, Q, P)
        term = torch.einsum("bhqp,bhqpd->bqhd", w, sampled)
        out = term if out is None else out + term
    return out.reshape(b, q, nh * hd)
