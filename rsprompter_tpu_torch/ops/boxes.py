"""Box ops: IoU and delta coding (torch).

Counterpart of ``rsprompter_tpu/ops/boxes.py`` (the reference's
``DeltaXYWHBBoxCoder`` and horizontal-box utilities), with a leading batch
dimension where the JAX package used ``vmap``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def take_per_image(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, P, ...) gathered along P by idx (B, K): JAX's vmapped take."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=eps)


def clip_to_shape(boxes: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """Clip xyxy boxes (..., 4) to [0, w] x [0, h]; ``hw`` (..., 2) broadcasts."""
    h, w = hw[..., 0:1], hw[..., 1:2]
    zero = torch.zeros_like(boxes[..., 0:1])
    lo = torch.cat([zero, zero, zero, zero], dim=-1)
    hi = torch.cat([w, h, w, h], dim=-1).to(boxes.dtype)
    return torch.maximum(torch.minimum(boxes, hi), lo)


class DeltaXYWHBBoxCoder:
    """(dx, dy, dw, dh) coding with target normalisation; decoding clamps
    dw/dh at log(wh_ratio_clip)."""

    def __init__(self, target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0)):
        self.means = np.asarray(target_means, np.float32)
        self.stds = np.asarray(target_stds, np.float32)

    def encode(self, boxes: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """boxes (..., 4) proposals, gt (..., 4) targets -> deltas (..., 4)."""
        eps = 1e-6
        pw = (boxes[..., 2] - boxes[..., 0]).clamp(min=eps)
        ph = (boxes[..., 3] - boxes[..., 1]).clamp(min=eps)
        px = (boxes[..., 0] + boxes[..., 2]) * 0.5
        py = (boxes[..., 1] + boxes[..., 3]) * 0.5
        gw = (gt[..., 2] - gt[..., 0]).clamp(min=eps)
        gh = (gt[..., 3] - gt[..., 1]).clamp(min=eps)
        gx = (gt[..., 0] + gt[..., 2]) * 0.5
        gy = (gt[..., 1] + gt[..., 3]) * 0.5
        deltas = torch.stack(
            [(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)],
            dim=-1,
        )
        means = torch.as_tensor(self.means, device=deltas.device)
        stds = torch.as_tensor(self.stds, device=deltas.device)
        return (deltas - means) / stds

    def decode(self, boxes: torch.Tensor, deltas: torch.Tensor,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
        stds = torch.as_tensor(self.stds, device=deltas.device)
        means = torch.as_tensor(self.means, device=deltas.device)
        deltas = deltas.float() * stds + means
        dx, dy, dw, dh = deltas.unbind(-1)
        max_ratio = float(np.abs(np.log(wh_ratio_clip)))
        dw = dw.clamp(-max_ratio, max_ratio)
        dh = dh.clamp(-max_ratio, max_ratio)
        boxes = boxes.float()
        pw = boxes[..., 2] - boxes[..., 0]
        ph = boxes[..., 3] - boxes[..., 1]
        px = (boxes[..., 0] + boxes[..., 2]) * 0.5
        py = (boxes[..., 1] + boxes[..., 3]) * 0.5
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        gx = px + pw * dx
        gy = py + ph * dy
        return torch.stack(
            [gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1
        )
