"""Single-level RoIAlign (torch, no torchvision).

Counterpart of ``rsprompter_tpu/ops/roi_align.py`` (``roi_align`` :58-96,
``_bilinear_gather`` :27-52), the mmcv / torchvision kernel's sampling:
continuous coordinates (a -0.5 offset with ``aligned=True``; without it each
RoI's width and height are clamped to at least 1), a fixed
``sampling_ratio x sampling_ratio`` grid in every output bin, averaged; a
sample counts only inside (-1, H) x (-1, W), and its corners are clamped
into the map (:func:`axis_corners`, which the multi-level extractor of the
RoI heads shares).

The Mask R-CNN mask targets (``models/roi_heads/mask_head.py``) run it over
the 0/1 ground-truth masks as they come: the four corners of each sample
are gathered in the masks' own dtype (``uint8``) and only they go to fp32,
so no fp32 copy of the whole mask stack is made.
"""

from __future__ import annotations

from typing import Tuple

import torch


def axis_corners(vs: torch.Tensor, lim: torch.Tensor):
    """Sample coordinates along one axis of a map ``lim`` long -> (lower and
    upper corner, the upper one's weight, inside (-1, lim))."""
    inside = (vs > -1.0) & (vs < lim)
    vc = vs.clamp(min=0.0)
    lo = torch.minimum(torch.floor(vc), lim - 1)
    hi = torch.minimum(lo + 1, lim - 1)
    frac = (vc - lo).clamp(0.0, 1.0)
    return lo, hi, frac, inside


def roi_align(
    features: torch.Tensor,  # (B, H, W, C), any dtype
    rois: torch.Tensor,  # (R, 5) [batch_idx, x1, y1, x2, y2]
    out_size: Tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """Returns (R, out_h, out_w, C) fp32 (float64 with float64 RoIs)."""
    out_h, out_w = out_size
    s = max(int(sampling_ratio), 1)
    _, h, w, c = features.shape
    r = rois.shape[0]
    dev = rois.device
    dt = torch.float64 if rois.dtype == torch.float64 else torch.float32
    rois = rois.to(dt)
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    roi_w = rois[:, 3] * spatial_scale - offset - x1
    roi_h = rois[:, 4] * spatial_scale - offset - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    sub = (torch.arange(s, dtype=dt, device=dev) + 0.5) / s

    def coords(start, size, n):  # (R, n * s) sample coordinates of one axis
        grid = (torch.arange(n, dtype=dt, device=dev)[:, None] + sub).reshape(-1)
        return start[:, None] + (size / n)[:, None] * grid

    y_lo, y_hi, ly, ins_y = axis_corners(coords(y1, roi_h, out_h),
                                         torch.tensor(float(h), dtype=dt, device=dev))
    x_lo, x_hi, lx, ins_x = axis_corners(coords(x1, roi_w, out_w),
                                         torch.tensor(float(w), dtype=dt, device=dev))
    hy, hx = 1.0 - ly, 1.0 - lx
    rows = features.reshape(-1, c)
    base = rois[:, 0].long() * h  # (R,)

    def corner(yi, xi):  # (R, ny), (R, nx) -> (R, ny, nx, C) in dt
        idx = (base[:, None] + yi.long())[:, :, None] * w + xi.long()[:, None, :]
        return rows[idx.reshape(-1)].reshape(r, yi.shape[1], xi.shape[1], c).to(dt)

    def weight(a, b):
        return (a[:, :, None] * b[:, None, :])[..., None]

    out = (corner(y_lo, x_lo) * weight(hy, hx) + corner(y_lo, x_hi) * weight(hy, lx)
           + corner(y_hi, x_lo) * weight(ly, hx) + corner(y_hi, x_hi) * weight(ly, lx))
    inside = (ins_y[:, :, None] & ins_x[:, None, :])[..., None]
    out = torch.where(inside, out, 0.0)
    return out.reshape(r, out_h, s, out_w, s, c).mean(dim=(2, 4))
