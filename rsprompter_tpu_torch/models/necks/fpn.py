"""Standard FPN neck (torch, NHWC) of the SAM-det detector.

Counterpart of ``rsprompter_tpu/models/necks/fpn.py`` (mmdet ``FPN`` with
in_channels (256, 512, 1024, 2048), 256 out, 5 outs, :17-45): 1x1 lateral
convs, a top-down nearest upsample added level by level, 3x3 output convs,
and a fifth level that takes every second pixel of the fourth (JAX's 1x1
stride-2 max-pool). ``jax.image.resize(..., 'nearest')`` samples at
half-pixel centres, which ``'nearest-exact'`` does at any ratio. Module names
are mmdet's (``lateral_convs.0.conv``, ``fpn_convs.0.conv``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import Conv2d


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: its ``conv`` alone."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(_ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3) for _ in in_channels
        )

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = F.interpolate(laterals[i].permute(0, 3, 1, 2),
                               size=laterals[i - 1].shape[1:3], mode="nearest-exact")
            laterals[i - 1] = laterals[i - 1] + up.permute(0, 2, 3, 1)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return tuple(outs)
