"""RSPrompter necks: ViT feature aggregators + ViTDet-style simple FPN (NHWC).

Counterpart of ``rsprompter_tpu/models/necks/rsfpn.py``: the multi-layer
``RSFeatureAggregator`` and the peft configs' ``PseudoFeatureAggregator``
(``aggregator_type='pseudo'``), then ``RSSimpleFPN``. Module names mirror
the reference's torch ``Sequential`` / ``ModuleList`` indices
(``downconvs.0.3``, ``fpn1.0``), so JAX variables convert mechanically.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import (
    BatchNorm2d,
    Conv2d,
    FastConvTranspose2x2,
    SamLayerNorm,
)


def _conv_bn_relu(cin: int, cout: int, k: int):
    return [Conv2d(cin, cout, k, padding=k // 2), BatchNorm2d(cout), nn.ReLU()]


class PseudoFeatureAggregator(nn.Module):
    """The encoder's image embeddings alone -> ``out_channels``: bias-free
    1x1, 3x3 and 3x3 convs, each followed by a LayerNorm (JAX :56-70; the
    reference's ``channel_fusion`` Sequential)."""

    def __init__(self, in_channels: int, hidden_channels: int = 64,
                 out_channels: int = 256):
        super().__init__()
        hc = hidden_channels
        self.channel_fusion = nn.Sequential(
            Conv2d(in_channels, hc, 1, bias=False), SamLayerNorm(hc),
            Conv2d(hc, hc, 3, padding=1, bias=False), SamLayerNorm(hc),
            Conv2d(hc, out_channels, 3, padding=1, bias=False), SamLayerNorm(out_channels),
        )

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        (x,) = inputs
        return self.channel_fusion(x)


def build_aggregator(aggregator_type: str, vcfg, hidden_channels: int,
                     select_layers: Sequence[int]) -> nn.Module:
    """The detectors' ``neck_feature_aggregator``: 'multi' reads the
    encoder's hidden states, 'pseudo' its image embeddings alone, with
    ``max(hidden_channels, 64)`` channels (JAX ``rsprompter_anchor.py:93-97``)."""
    if aggregator_type == "pseudo":
        return PseudoFeatureAggregator(vcfg.output_channels, max(hidden_channels, 64), 256)
    if aggregator_type != "multi":
        raise ValueError(f"aggregator_type={aggregator_type!r}: 'multi' or 'pseudo'")
    return RSFeatureAggregator(vcfg.hidden_size, hidden_channels, 256, select_layers,
                               vcfg.num_hidden_layers)


class RSFeatureAggregator(nn.Module):
    """Multi-layer ViT hidden-state aggregator (the paper's design)."""

    def __init__(self, in_channels: int, hidden_channels: int = 32,
                 out_channels: int = 256, select_layers: Sequence[int] = tuple(range(1, 13, 2)),
                 num_layers: int = 12):
        super().__init__()
        hc = hidden_channels
        self.select_layers = tuple(select_layers)
        self.num_layers = num_layers
        self.downconvs = nn.ModuleList(
            nn.Sequential(*_conv_bn_relu(in_channels, hc, 1), *_conv_bn_relu(hc, hc, 3))
            for _ in self.select_layers
        )
        self.hidden_convs = nn.ModuleList(
            nn.Sequential(*_conv_bn_relu(hc, hc, 3)) for _ in self.select_layers
        )
        self.fusion_conv = nn.Sequential(
            *_conv_bn_relu(hc, out_channels, 1),
            *_conv_bn_relu(out_channels, out_channels, 3),
            Conv2d(out_channels, out_channels, 3, padding=1),
        )

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(inputs) != self.num_layers + 1:
            raise ValueError(f"expected {self.num_layers + 1} hidden states, got {len(inputs)}")
        feats = [conv(inputs[i]) for conv, i in zip(self.downconvs, self.select_layers)]
        x = None
        for conv, h in zip(self.hidden_convs, feats):
            if x is not None:
                h = x + h
            x = h + conv(h)
        return self.fusion_conv(x)


class _ConvModule(nn.Module):
    """Bias-free conv + LN (mmcv ConvModule keys ``conv`` / ``ln``)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.ln = SamLayerNorm(cout)

    def forward(self, x):
        return self.ln(self.conv(x))


def _max_pool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


class RSSimpleFPN(nn.Module):
    """One 256-ch map -> 4 scales (deconv x2, deconv, identity, maxpool) ->
    lateral + fpn convs, plus stride-2 subsampled extra levels."""

    def __init__(self, backbone_channel: int = 256,
                 in_channels: Tuple[int, ...] = (64, 128, 256, 256),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        c = backbone_channel
        self.num_outs = num_outs
        self.fpn1 = nn.Sequential(
            FastConvTranspose2x2(c, c // 2), SamLayerNorm(c // 2), nn.GELU(),
            FastConvTranspose2x2(c // 2, c // 4),
        )
        self.fpn2 = nn.Sequential(FastConvTranspose2x2(c, c // 2))
        self.lateral_convs = nn.ModuleList(_ConvModule(ci, out_channels, 1) for ci in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3) for _ in in_channels
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        inputs = [self.fpn1(x), self.fpn2(x), x, _max_pool(x, 2, 2)]
        outs = [fpn(lat(inp)) for inp, lat, fpn in zip(inputs, self.lateral_convs, self.fpn_convs)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return tuple(outs)
