"""Multi-level RoIAlign over an FPN pyramid (torch, no torchvision).

Counterpart of ``rsprompter_tpu/models/roi_heads/roi_extractor.py``: level by
``floor(log2(sqrt(wh) / 56))``, then mmcv RoIAlign (``aligned=True``) on that
level. ``sampling_ratio=0`` is mmcv's adaptive rule, ``ceil(bin)`` samples per
bin, exact up to ``max_adaptive_ratio`` (bins stay <= 4 with FPN level
mapping); the border rule is the single-level RoIAlign's
(``ops/roi_align.py``). The pyramid is flattened into one (B * sum HW, C)
table so the whole extraction is one gather of the bilinear corner grid plus
two per-axis weighted contractions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from rsprompter_tpu_torch.ops.roi_align import axis_corners


def map_roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56) -> torch.Tensor:
    """rois (R, 5) -> level index (R,) int64."""
    scale = torch.sqrt((rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2]))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def extract_roi_feats(
    feats: Sequence[torch.Tensor],  # per-level NHWC maps
    rois: torch.Tensor,  # (R, 5) [batch_idx, x1, y1, x2, y2], image coords
    out_size: Tuple[int, int] = (7, 7),
    featmap_strides: Sequence[int] = (4, 8, 16, 32),
    finest_scale: int = 56,
    sampling_ratio: int = 2,
    max_adaptive_ratio: int = 4,
) -> torch.Tensor:
    """Returns (R, out_h, out_w, C) in the features' dtype."""
    dev = rois.device
    num_levels = len(featmap_strides)
    target = map_roi_levels(rois, num_levels, finest_scale)
    b, _, _, c = feats[0].shape
    r = rois.shape[0]
    out_h, out_w = out_size
    adaptive = sampling_ratio == 0
    s = max_adaptive_ratio if adaptive else max(int(sampling_ratio), 1)

    flat = torch.cat([f.reshape(b, -1, c) for f in feats], dim=1)
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    starts = np.cumsum([0] + [h * w for h, w in sizes])[:-1]
    lvl_h = torch.tensor([h for h, _ in sizes], dtype=torch.float32, device=dev)[target]
    lvl_w = torch.tensor([w for _, w in sizes], dtype=torch.float32, device=dev)[target]
    lvl_start = torch.as_tensor(starts, dtype=torch.long, device=dev)[target]
    scale = torch.tensor([1.0 / st for st in featmap_strides], dtype=torch.float32,
                         device=dev)[target]

    batch_idx = rois[:, 0].long()
    x1 = rois[:, 1] * scale - 0.5
    y1 = rois[:, 2] * scale - 0.5
    x2 = rois[:, 3] * scale - 0.5
    y2 = rois[:, 4] * scale - 0.5
    bin_h = (y2 - y1) / out_h
    bin_w = (x2 - x1) / out_w

    if adaptive:
        ry = torch.ceil(bin_h).clamp(1, s)[:, None]  # (R, 1)
        rx = torch.ceil(bin_w).clamp(1, s)[:, None]
        j = torch.arange(s, dtype=torch.float32, device=dev)[None, :]  # (1, s)
        fy = torch.where(j[None] < ry[..., None], j[None], 0.0)  # (R, 1, s)
        fx = torch.where(j[None] < rx[..., None], j[None], 0.0)
        oy = (fy + 0.5) / ry[..., None]
        ox = (fx + 0.5) / rx[..., None]
        iy = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None] + oy
        ix = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :, None] + ox
        ys = y1[:, None] + bin_h[:, None] * iy.reshape(r, -1)  # (R, n_y)
        xs = x1[:, None] + bin_w[:, None] * ix.reshape(r, -1)
        my = (j[None] < ry[..., None]).float().expand(r, out_h, s).reshape(r, -1)
        mx = (j[None] < rx[..., None]).float().expand(r, out_w, s).reshape(r, -1)
    else:
        ar = (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s
        iy = (torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] + ar).reshape(-1)
        ix = (torch.arange(out_w, dtype=torch.float32, device=dev)[:, None] + ar).reshape(-1)
        ys = y1[:, None] + bin_h[:, None] * iy[None, :]
        xs = x1[:, None] + bin_w[:, None] * ix[None, :]
        my = torch.ones((r, out_h * s), device=dev)
        mx = torch.ones((r, out_w * s), device=dev)

    y_lo, y_hi, ly, ins_y = axis_corners(ys, lvl_h[:, None])
    x_lo, x_hi, lx, ins_x = axis_corners(xs, lvl_w[:, None])
    n_y, n_x = ys.shape[1], xs.shape[1]

    base = batch_idx * flat.shape[1] + lvl_start  # (R,)
    ygrid = torch.cat([y_lo, y_hi], dim=1).long()  # (R, 2 n_y)
    xgrid = torch.cat([x_lo, x_hi], dim=1).long()
    idx = base[:, None, None] + ygrid[:, :, None] * lvl_w.long()[:, None, None] + xgrid[:, None, :]
    # the gather's backward must sum in a fixed order for a resumed run to
    # equal an uninterrupted one: on the CPU index_select's (index_add_, in
    # index order; an indexing gather's index_put_ accumulate adds with
    # atomics across threads there), on the card the indexing gather's
    # (a sorted accumulate; index_add_ adds with atomics there)
    rows, flat_idx = flat.reshape(-1, c), idx.reshape(-1)
    v = rows[flat_idx] if rows.is_cuda else rows.index_select(0, flat_idx)
    v = v.reshape(r, 2 * n_y, 2 * n_x, c)

    oh_y = torch.as_tensor(
        ((np.arange(n_y) // s)[None, :] == np.arange(out_h)[:, None]).astype(np.float32),
        device=dev,
    )  # (out_h, n_y)
    oh_x = torch.as_tensor(
        ((np.arange(n_x) // s)[None, :] == np.arange(out_w)[:, None]).astype(np.float32),
        device=dev,
    )
    wy_s = my * ins_y.float()
    wx_s = mx * ins_x.float()
    wy = torch.cat([(1.0 - ly) * wy_s, ly * wy_s], dim=1)  # (R, 2 n_y)
    wx = torch.cat([(1.0 - lx) * wx_s, lx * wx_s], dim=1)
    wy_b = (wy[:, None, :] * torch.cat([oh_y, oh_y], dim=1)[None]).to(flat.dtype)
    wx_b = (wx[:, None, :] * torch.cat([oh_x, oh_x], dim=1)[None]).to(flat.dtype)
    # the corner grid v is the largest tensor here (R x 2n_y x 2n_x x C):
    # contract it in its own dtype (fp32 accumulation), then go to fp32
    t = torch.einsum("riu,ruvc->rivc", wy_b, v)
    out = torch.einsum("rjv,rivc->rijc", wx_b.float(), t.float())
    count = (my @ oh_y.T)[:, :, None] * (mx @ oh_x.T)[:, None, :]
    return (out / count[..., None]).to(flat.dtype)
