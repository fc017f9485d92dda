"""MSDeformAttn pixel decoder (torch, NHWC).

Counterpart of ``rsprompter_tpu/models/dense_heads/pixel_decoder.py``
(reference ``mmdet/models/layers/msdeformattn_pixel_decoder.py``): the
``num_encoder_levels`` lowest-resolution maps are projected to
``feat_channels`` (1x1 conv + GroupNorm), run through deformable-attention
encoder layers over the tokens of all levels at once, and an FPN top-down
pass adds the remaining high-resolution levels. Returns ``(mask_feature
(stride-4 map, out_channels), memorys low -> high resolution)``.

Parameter names follow the mmdet modules (``input_convs.0.conv``,
``input_convs.0.gn``, ``level_encoding``, ``encoder.layers.0``, ...), so a
reference checkpoint maps onto them; ``utils/convert.py`` maps the JAX
names. Norms are flax's (eps 1e-6, fp32 output), as in JAX.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.layers import sine_positional_encoding
from rsprompter_tpu_torch.models.sam.common import Conv2d, GroupNorm, LayerNorm, Linear
from rsprompter_tpu_torch.ops.msdeform_attn import ms_deform_attn_core
from rsprompter_tpu_torch.ops.resize import resize


class MSDeformAttention(nn.Module):
    """One multi-scale deformable self-attention op."""

    def __init__(self, embed_dims: int = 128, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.value_proj = Linear(embed_dims, embed_dims)
        self.sampling_offsets = Linear(embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(embed_dims, num_heads * num_levels * num_points)
        self.output_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points, spatial_shapes):
        """query (B, Q, C) (position added), value (B, V, C), reference
        points (B, Q, L, 2) in [0, 1] (x, y) -> (B, Q, C)."""
        b, q, c = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value)
        offsets = self.sampling_offsets(query).reshape(b, q, nh, nl, npt, 2)
        weights = self.attention_weights(query).reshape(b, q, nh, nl * npt)
        weights = torch.softmax(weights.float(), dim=-1).reshape(b, q, nh, nl, npt)
        value_levels = []
        start = 0
        for h, w in spatial_shapes:
            value_levels.append(v[:, start : start + h * w].reshape(b, h, w, nh, c // nh))
            start += h * w
        wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                          device=query.device)
        locs = reference_points[:, :, None, :, None, :] + offsets.float() / wh[:, None, :]
        out = ms_deform_attn_core(value_levels, locs, weights)
        return self.output_proj(out.to(query.dtype))


class FFN(nn.Module):
    """x + fc2(relu(fc1(x))), named as mmcv's ``FFN`` (``layers.0.0``, ``layers.1``)."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dims, feedforward_channels), nn.ReLU()),
            Linear(feedforward_channels, embed_dims),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x)


class DeformableEncoderLayer(nn.Module):
    """Post-norm: self_attn -> add -> LN -> FFN (+ residual) -> LN."""

    def __init__(self, embed_dims: int = 128, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4, feedforward_channels: int = 512):
        super().__init__()
        self.self_attn = MSDeformAttention(embed_dims, num_heads, num_levels, num_points)
        self.norms = nn.ModuleList([LayerNorm(embed_dims), LayerNorm(embed_dims)])
        self.ffn = FFN(embed_dims, feedforward_channels)

    def forward(self, x, pos, reference_points, spatial_shapes):
        x = x + self.self_attn(x + pos, x, reference_points, spatial_shapes)
        x = self.norms[0](x)
        return self.norms[1](self.ffn(x))


class DeformableEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(**layer_kw) for _ in range(num_layers))

    def forward(self, x, pos, reference_points, spatial_shapes):
        for layer in self.layers:
            x = layer(x, pos, reference_points, spatial_shapes)
        return x


class ConvGN(nn.Module):
    """mmcv ``ConvModule`` with GroupNorm: conv -> gn (-> relu)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool, relu: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=bias)
        self.gn = GroupNorm(cout)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gn(self.conv(x))
        return F.relu(y) if self.relu else y


def _reference_points(h: int, w: int) -> torch.Tensor:
    """Pixel centres normalised by the level's extent: (h*w, 2) in (x, y)."""
    ys = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(h * w, 2)


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels: int = 256, feat_channels: int = 128,
                 out_channels: int = 256, num_levels: int = 5, num_encoder_levels: int = 3,
                 num_encoder_layers: int = 3, num_outs: int = 3, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 512):
        super().__init__()
        self.num_encoder_levels = num_encoder_levels
        self.num_outs = num_outs
        self.feat_channels = feat_channels
        self.input_convs = nn.ModuleList(
            ConvGN(in_channels, feat_channels, 1, bias=True) for _ in range(num_encoder_levels)
        )
        self.level_encoding = nn.Embedding(num_encoder_levels, feat_channels)
        self.encoder = DeformableEncoder(
            num_encoder_layers, embed_dims=feat_channels, num_heads=num_heads,
            num_levels=num_encoder_levels, num_points=num_points,
            feedforward_channels=feedforward_channels,
        )
        n_fpn = num_levels - num_encoder_levels
        self.lateral_convs = nn.ModuleList(
            ConvGN(in_channels, feat_channels, 1, bias=False) for _ in range(n_fpn)
        )
        self.output_convs = nn.ModuleList(
            ConvGN(feat_channels, feat_channels, 3, bias=False, relu=True) for _ in range(n_fpn)
        )
        self.mask_feature = Conv2d(feat_channels, out_channels, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: per-level NHWC maps, high -> low resolution."""
        n_in = len(feats)
        b = feats[0].shape[0]
        dev = feats[0].device
        tokens, poss, shapes, refs = [], [], [], []
        for i in range(self.num_encoder_levels):
            f = feats[n_in - i - 1]  # from the lowest resolution up
            h, w = f.shape[1:3]
            x = self.input_convs[i](f)
            pe = sine_positional_encoding(h, w, num_feats=self.feat_channels // 2).to(dev)
            pos = (pe + self.level_encoding.weight[i]).reshape(1, h * w, -1)
            tokens.append(x.reshape(b, h * w, -1))
            poss.append(pos.expand(b, h * w, self.feat_channels))
            shapes.append((h, w))
            refs.append(_reference_points(h, w))
        x = torch.cat(tokens, dim=1)
        pos = torch.cat(poss, dim=1)
        ref = torch.cat(refs, dim=0).to(dev)
        ref = ref[None, :, None, :].expand(b, ref.shape[0], self.num_encoder_levels, 2)
        x = self.encoder(x, pos, ref, shapes)

        outs: List[torch.Tensor] = []
        start = 0
        for h, w in shapes:  # low -> high resolution
            outs.append(x[:, start : start + h * w].reshape(b, h, w, -1))
            start += h * w
        for i in range(n_in - self.num_encoder_levels - 1, -1, -1):  # FPN top-down
            lat = self.lateral_convs[i](feats[i])
            prev = outs[-1]
            up = resize(prev, (b, lat.shape[1], lat.shape[2], prev.shape[-1]), "bilinear")
            outs.append(self.output_convs[i](lat + up))
        return self.mask_feature(outs[-1]), outs[: self.num_outs]
