"""FCN mask head of SAM-seg Mask R-CNN, its targets and loss, and the host
RoI paste (torch).

Counterpart of ``rsprompter_tpu/models/roi_heads/mask_head.py``:
``FCNMaskHead`` (:28-50; reference ``fcn_mask_head.py:29``) is four 3x3
convs + ReLU, a 2x2 stride-2 transposed conv ``upsample`` + ReLU and a 1x1
``conv_logits``, so a 14^2 RoI feature gives 28^2 mask logits;
:func:`mask_targets_from_rois` (:53-68) crops each RoI's matched GT mask to
28^2 with RoIAlign (``aligned=False``, 2 x 2 samples a bin) and binarises it
at 0.5; :func:`fcn_mask_loss` (:71-84) is the per-RoI mask CE on the RoI's
label channel; :func:`paste_masks_np` is the port's copy of
``paste_masks_np`` (:87-121, mmdet's ``_do_paste_mask``): each RoI map
bilinearly resampled into its box of the target image and thresholded.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.losses import mask_cross_entropy
from rsprompter_tpu_torch.models.sam.common import Conv2d, FastConvTranspose2x2
from rsprompter_tpu_torch.ops.roi_align import roi_align


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` (conv + ReLU): its ``conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class FCNMaskHead(nn.Module):
    def __init__(self, num_classes: int = 1, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4,
                 class_agnostic: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            _ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels)
            for i in range(num_convs)
        )
        self.upsample = FastConvTranspose2x2(conv_out_channels, conv_out_channels)
        self.conv_logits = Conv2d(conv_out_channels, 1 if class_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (R, h, w, C) -> mask logits (R, 2h, 2w, classes or 1)."""
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x)))


def mask_targets_from_rois(
    gt_masks: torch.Tensor,  # (B, G, H, W), 0 / 1, any dtype
    rois: torch.Tensor,  # (R, 5) [batch_idx, x1, y1, x2, y2] in image pixels
    gt_inds: torch.Tensor,  # (R,) 1-based matched GT (0: none; clamped, masked later)
    mask_size: Tuple[int, int] = (28, 28),
) -> torch.Tensor:
    """(R, *mask_size) fp32 0 / 1: each RoI's matched GT mask cropped."""
    b, g, h, w = gt_masks.shape
    flat_idx = rois[:, 0].long() * g + (gt_inds.long() - 1).clamp(0, g - 1)
    rois_flat = torch.cat([flat_idx[:, None].to(rois.dtype), rois[:, 1:]], dim=1)
    crops = roi_align(gt_masks.reshape(b * g, h, w, 1), rois_flat, mask_size, 1.0,
                      sampling_ratio=2, aligned=False)
    return (crops[..., 0] >= 0.5).float()


def fcn_mask_loss(
    mask_logits: torch.Tensor,  # (R, S, S, classes or 1)
    mask_targets: torch.Tensor,  # (R, S, S)
    labels: torch.Tensor,  # (R,)
    pos_valid: torch.Tensor,  # (R,) bool
    class_agnostic: bool = False,
) -> torch.Tensor:
    """Mask CE of each positive RoI on its label's channel (the only one
    when class-agnostic), averaged over pixels, then over the positives."""
    if class_agnostic:
        logits = mask_logits[..., 0]
    else:
        idx = labels.long().clamp(0, mask_logits.shape[-1] - 1)
        logits = torch.gather(mask_logits, 3, idx[:, None, None, None].expand(
            -1, mask_logits.shape[1], mask_logits.shape[2], 1))[..., 0]
    return mask_cross_entropy(logits.float(), mask_targets, valid=pos_valid)


def paste_masks_np(
    masks: np.ndarray,  # (N, S, S) sigmoid probabilities
    boxes: np.ndarray,  # (N, 4) xyxy in target image coords
    img_h: int,
    img_w: int,
    thr: float = 0.5,
) -> np.ndarray:
    """(N, img_h, img_w) bool: each map resampled into its box (bilinear,
    pixel centres, edges clamped) and thresholded; empty outside the box."""
    n = len(masks)
    out = np.zeros((n, img_h, img_w), dtype=bool)
    for i in range(n):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1i, y1i = max(x1i, 0), max(y1i, 0)
        x2i, y2i = min(x2i, img_w), min(y2i, img_h)
        if x2i <= x1i or y2i <= y1i:
            continue
        ys = (np.arange(y1i, y2i) + 0.5 - y1) / max(y2 - y1, 1e-6) * masks.shape[1] - 0.5
        xs = (np.arange(x1i, x2i) + 0.5 - x1) / max(x2 - x1, 1e-6) * masks.shape[2] - 0.5
        ys0 = np.clip(np.floor(ys).astype(int), 0, masks.shape[1] - 1)
        xs0 = np.clip(np.floor(xs).astype(int), 0, masks.shape[2] - 1)
        ys1 = np.clip(ys0 + 1, 0, masks.shape[1] - 1)
        xs1 = np.clip(xs0 + 1, 0, masks.shape[2] - 1)
        wy = np.clip(ys - ys0, 0, 1)[:, None]
        wx = np.clip(xs - xs0, 0, 1)[None, :]
        m = masks[i]
        patch = (
            m[ys0[:, None], xs0[None, :]] * (1 - wy) * (1 - wx)
            + m[ys0[:, None], xs1[None, :]] * (1 - wy) * wx
            + m[ys1[:, None], xs0[None, :]] * wy * (1 - wx)
            + m[ys1[:, None], xs1[None, :]] * wy * wx
        )
        out[i, y1i:y2i, x1i:x2i] = patch >= thr
    return out
