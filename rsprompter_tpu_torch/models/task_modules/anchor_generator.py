"""Grid anchor generation (host-side numpy; anchors are trace-time constants).

Behavior parity: reference
``mmdet/models/task_modules/prior_generators/anchor_generator.py:18`` with the
RSPrompter config (scales [4,8], ratios [.5,1,2], strides [4,8,16,32,64];
``configs/rsprompter/_base_/rsprompter_anchor.py`` rpn_head.anchor_generator).
Anchors are computed once in numpy and folded into the XLA graph as constants
— there is no reason to generate them on device every step.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    def __init__(
        self,
        strides: Sequence[int],
        ratios: Sequence[float] = (0.5, 1.0, 2.0),
        scales: Sequence[float] = (8,),
        base_sizes: Sequence[int] = None,
        center_offset: float = 0.0,
    ):
        self.strides = [int(s) for s in strides]
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self.base_sizes = (
            [int(b) for b in base_sizes] if base_sizes is not None else self.strides
        )
        self.center_offset = center_offset
        self._uploaded = {}  # (feature-map sizes, device) -> per-level tensors
        self.base_anchors = [
            self._base_anchors(bs, stride)
            for bs, stride in zip(self.base_sizes, self.strides)
        ]

    @property
    def num_base_priors(self) -> int:
        return len(self.ratios) * len(self.scales)

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def _base_anchors(self, base_size: int, stride: int) -> np.ndarray:
        w = h = float(base_size)
        cx = self.center_offset * stride
        cy = self.center_offset * stride
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack(
            [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], axis=-1
        ).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Per-level anchors, each (H*W*A, 4) in row-major (y, x, anchor) order."""
        out = []
        for (fh, fw), stride, base in zip(featmap_sizes, self.strides, self.base_anchors):
            shift_x = np.arange(fw, dtype=np.float32) * stride
            shift_y = np.arange(fh, dtype=np.float32) * stride
            sx, sy = np.meshgrid(shift_x, shift_y)
            shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
            anchors = (shifts + base[None]).reshape(-1, 4)
            out.append(anchors.astype(np.float32))
        return out

    def flat_anchors(self, featmap_sizes) -> np.ndarray:
        """All levels concatenated: (sum_l H_l*W_l*A, 4)."""
        return np.concatenate(self.grid_anchors(featmap_sizes), axis=0)

    def num_level_anchors(self, featmap_sizes) -> List[int]:
        return [
            fh * fw * self.num_base_priors for (fh, fw) in featmap_sizes
        ]

    def device_anchors(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-level anchors of NHWC feature maps on their device, built and
        uploaded once per feature-map shape and device."""
        sizes = tuple(tuple(f.shape[1:3]) for f in feats)
        key = (sizes, feats[0].device)
        if key not in self._uploaded:
            self._uploaded[key] = [torch.as_tensor(a, device=feats[0].device)
                                   for a in self.grid_anchors(sizes)]
        return self._uploaded[key]
