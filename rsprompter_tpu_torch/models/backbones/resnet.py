"""ResNet backbone (torch, NHWC) of the SAM-det detector.

Counterpart of ``rsprompter_tpu/models/backbones/resnet.py`` (mmdet's
torchvision-style ResNet, ``ResNet`` :88-123): a 7x7 stride-2 stem, a 3x3
stride-2 max-pool, then four stages of basic or bottleneck blocks, the
stride on the block's 3x3 conv (:75); returns the C2..C5 maps. Module names
are torchvision's / mmdet's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0`` / ``.1``), so their checkpoints load by name.

Every BatchNorm is :class:`FrozenBatchNorm2d`: it normalises with its
running statistics in train mode too, as JAX's ``_FrozenBN`` (:30-37,
mmdet's ``norm_eval``) does. JAX pads the pool's input with -inf and pools
VALID (:103-104), which is ``F.max_pool2d(x, 3, 2, 1)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import BatchNorm2d, Conv2d

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


class FrozenBatchNorm2d(BatchNorm2d):
    """BatchNorm on NHWC input that always uses its running statistics (eps
    1e-5), whatever the module's train / eval mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return ((x.float() - self.running_mean.float()) * mul + self.bias.float()).to(x.dtype)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False), FrozenBatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, base_channels: int = 64,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block = BasicBlock if block_type == "basic" else Bottleneck
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, base_channels, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(base_channels)
        inplanes, planes = base_channels, base_channels
        for stage, n_blocks in enumerate(stage_blocks):
            stride = 1 if stage == 0 else 2
            blocks = []
            for i in range(n_blocks):
                # a projection shortcut where the stride or the width changes
                blocks.append(block(
                    inplanes, planes, stride if i == 0 else 1,
                    downsample=i == 0 and (stride != 1 or inplanes != planes * block.expansion),
                ))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, H, W, 3) -> the ``out_indices`` stage maps, NHWC."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
