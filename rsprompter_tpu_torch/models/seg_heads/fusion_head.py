"""MaskFormer fusion head: query outputs -> padded instance detections (torch).

Counterpart of ``rsprompter_tpu/models/seg_heads/fusion_head.py`` (reference
``RSMaskFormerFusionHead``): top-k over the (query x class) softmax scores,
background dropped, rescored by the mean probability inside each binary
mask, boxes from the masks. Batched over images; the top-k keeps the lower
flat index first on ties, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
from rsprompter_tpu_torch.ops.boxes import take_per_image
from rsprompter_tpu_torch.ops.nms import sort_desc


def mask2bbox(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) binary -> (..., 4) tight xyxy boxes, zeros for an empty mask."""
    h, w = masks.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    any_row = masks.any(dim=-1)
    any_col = masks.any(dim=-2)
    big = 1e9
    y1 = torch.where(any_row, ys, big).amin(dim=-1)
    y2 = torch.where(any_row, ys, -big).amax(dim=-1) + 1
    x1 = torch.where(any_col, xs, big).amin(dim=-1)
    x2 = torch.where(any_col, xs, -big).amax(dim=-1) + 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    return torch.where(any_row.any(dim=-1)[..., None], boxes, 0.0)


def instance_postprocess(
    cls_logits: torch.Tensor,  # (B, Q, C+1)
    mask_logits: torch.Tensor,  # (B, Q, h, w)
    num_classes: int,
    max_per_image: int = 100,
    scale_boxes: float = 1.0,
) -> Tuple[DetResult, torch.Tensor]:
    """Returns (DetResult at mask resolution * scale_boxes, mask probs
    (B, k, h, w) fp32), k = min(max_per_image, Q * num_classes)."""
    b = cls_logits.shape[0]
    scores = torch.softmax(cls_logits.float(), dim=-1)[..., :num_classes].reshape(b, -1)
    k = min(max_per_image, scores.shape[1])
    top_scores, top_idx = sort_desc(scores, k)
    labels = top_idx % num_classes
    probs = torch.sigmoid(take_per_image(mask_logits, top_idx // num_classes).float())
    binary = probs > 0.5
    area = binary.sum(dim=(2, 3)).float().clamp(min=1e-6)
    mask_scores = (probs * binary).sum(dim=(2, 3)) / area
    dets = DetResult(
        boxes=mask2bbox(binary) * scale_boxes, scores=top_scores * mask_scores,
        labels=labels, valid=binary.any(dim=-1).any(dim=-1),
    )
    return dets, probs
