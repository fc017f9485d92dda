"""RSPrompter-query head: Mask2Former decoder that prompts SAM (torch, NHWC).

Counterpart of the prediction half of
``rsprompter_tpu/models/dense_heads/mask2former_head.py`` (reference
``RSMask2FormerHead``, ``mmdet/rsprompter/models.py:275-658``) with
``sam_prompting`` and ``decoder_plus``: after each decoder layer every query
gives class logits, ``per_pointset_point`` sparse SAM prompts (``point_emb``
MLP with interleaved sin), and a mask-feature product ("plus" mask logits)
whose ``SamMaskEmbedding`` is its dense SAM prompt; the plus mask, resized to
the next memory level, is that layer's cross-attention mask. At predict only
the last layer's prompts go through the SAM mask decoder
(``decode_last_only``): the attention masks come from the plus stream.
The losses and Hungarian matching come with the query train step.

Norms are flax's (eps 1e-6, fp32 output) and the head's MLPs stay fp32 as
JAX builds them without ``dtype=``; the attention projections compute in the
model's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.dense_heads.pixel_decoder import (
    FFN,
    MSDeformAttnPixelDecoder,
)
from rsprompter_tpu_torch.models.layers import sine_positional_encoding
from rsprompter_tpu_torch.models.sam.common import Fp32Linear, LayerNorm, Linear
from rsprompter_tpu_torch.models.sam.configs import (
    SamMaskDecoderConfig,
    SamPromptEncoderConfig,
)
from rsprompter_tpu_torch.models.sam.mask_decoder import SamMaskDecoder
from rsprompter_tpu_torch.models.sam.prompt_encoder import SamMaskEmbedding
from rsprompter_tpu_torch.ops.resize import resize


class MultiheadAttention(nn.Module):
    """Multi-head attention; ``attn_mask`` True = blocked (-1e9 before the softmax)."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dims, embed_dims)
        self.k_proj = Linear(embed_dims, embed_dims)
        self.v_proj = Linear(embed_dims, embed_dims)
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, key, value, attn_mask: Optional[torch.Tensor] = None):
        b, t, c = query.shape
        nh = self.num_heads

        def split(x):
            return x.reshape(b, -1, nh, c // nh).transpose(1, 2)

        q, k, v = split(self.q_proj(query)), split(self.k_proj(key)), split(self.v_proj(value))
        scores = torch.einsum("bntd,bnsd->bnts", q.float(), k.float()) / (c // nh) ** 0.5
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask, -1e9)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bnts,bnsd->bntd", probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class Mask2FormerDecoderLayer(nn.Module):
    """Masked cross-attention -> LN -> self-attention -> LN -> FFN -> LN."""

    def __init__(self, embed_dims: int = 128, num_heads: int = 8,
                 feedforward_channels: int = 512):
        super().__init__()
        self.cross_attn = MultiheadAttention(embed_dims, num_heads)
        self.self_attn = MultiheadAttention(embed_dims, num_heads)
        self.norms = nn.ModuleList(LayerNorm(embed_dims) for _ in range(3))
        self.ffn = FFN(embed_dims, feedforward_channels)

    def forward(self, query, query_pos, memory, memory_pos, cross_attn_mask):
        query = query + self.cross_attn(
            query + query_pos, memory + memory_pos, memory, cross_attn_mask
        )
        query = self.norms[0](query)
        q = query + query_pos
        query = self.norms[1](query + self.self_attn(q, q, query))
        return self.norms[2](self.ffn(query))


class Mask2FormerTransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, embed_dims: int, num_heads: int,
                 feedforward_channels: int):
        super().__init__()
        self.layers = nn.ModuleList(
            Mask2FormerDecoderLayer(embed_dims, num_heads, feedforward_channels)
            for _ in range(num_layers)
        )
        self.post_norm = LayerNorm(embed_dims)


def _mlp(dims: Sequence[int]) -> nn.Sequential:
    """Fp32 linears with ReLU between them (indices 0, 2, 4, ... as mmdet's)."""
    mods: List[nn.Module] = []
    for i in range(len(dims) - 1):
        if i:
            mods.append(nn.ReLU())
        mods.append(Fp32Linear(dims[i], dims[i + 1]))
    return nn.Sequential(*mods)


class Mask2FormerHead(nn.Module):
    def __init__(self, decoder_config: SamMaskDecoderConfig, num_classes: int = 1,
                 num_queries: int = 100, feat_channels: int = 128, out_channels: int = 256,
                 num_transformer_feat_level: int = 3, num_decoder_layers: int = 6,
                 num_heads: int = 8, feedforward_channels: int = 512,
                 per_pointset_point: int = 5, with_sincos: bool = True):
        super().__init__()
        self.num_queries = num_queries
        self.feat_channels = feat_channels
        self.num_levels = num_transformer_feat_level
        self.per_pointset_point = per_pointset_point
        self.with_sincos = with_sincos
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels=256, feat_channels=feat_channels, out_channels=out_channels,
            num_encoder_levels=num_transformer_feat_level,
            num_outs=num_transformer_feat_level,
        )
        self.transformer_decoder = Mask2FormerTransformerDecoder(
            num_decoder_layers, feat_channels, num_heads, feedforward_channels
        )
        self.query_embed = nn.Embedding(num_queries, feat_channels)
        self.query_feat = nn.Embedding(num_queries, feat_channels)
        self.level_embed = nn.Embedding(num_transformer_feat_level, feat_channels)
        self.cls_embed = _mlp((feat_channels, feat_channels, num_classes + 1))
        num_sincos = 2 if with_sincos else 1
        self.point_emb = _mlp((feat_channels, feat_channels // 2, feat_channels // 2,
                               out_channels * num_sincos * per_pointset_point))
        self.mask_decoder = SamMaskDecoder(decoder_config)
        self.sam_mask_embed = SamMaskEmbedding(
            SamPromptEncoderConfig(hidden_size=decoder_config.hidden_size)
        )
        self.mask_embed = _mlp((feat_channels, feat_channels, feat_channels, out_channels))

    def _forward_head(self, decoder_out, mask_feature, attn_hw, image_embeddings,
                      image_pe, decode: bool):
        """-> (class logits (B, Q, C+1), SAM mask logits (B, Q, 4h, 4w) or
        None when ``decode`` is False, next attention mask)."""
        b, q, _ = decoder_out.shape
        x = self.transformer_decoder.post_norm(decoder_out)
        cls_pred = self.cls_embed(x)
        mask_plus = torch.einsum(
            "bqc,bhwc->bqhw", self.mask_embed(x).float(), mask_feature.float()
        )
        mask_pred = None
        if decode:
            pts = self.point_emb(x).reshape(b, q, self.per_pointset_point, -1)
            if self.with_sincos:
                pts = torch.sin(pts[..., ::2]) + pts[..., 1::2]
            h4, w4 = mask_plus.shape[2:]
            dense = self.sam_mask_embed(mask_plus.reshape(b * q, h4, w4, 1))
            dense = dense.reshape(b, q, *dense.shape[1:])  # (B, Q, h, w, C)
            masks, _ = self.mask_decoder(
                image_embeddings, image_pe.expand(b, *image_pe.shape[1:]), pts, dense
            )
            mask_pred = masks[:, :, 0]
        return cls_pred, mask_pred, self._next_attn_mask(mask_plus, attn_hw)

    @staticmethod
    def _next_attn_mask(mask_plus: torch.Tensor, attn_hw: Tuple[int, int]) -> torch.Tensor:
        """(B, Q, H4, W4) logits -> (B, 1, Q, h*w) blocked entries (True): the
        antialiased bilinear resize of ``jax.image.resize``, then sigmoid < 0.5;
        a query blocked everywhere is unblocked everywhere."""
        b, q = mask_plus.shape[:2]
        am = resize(mask_plus, (b, q) + tuple(attn_hw), "bilinear")
        am = (torch.sigmoid(am) < 0.5).reshape(b, 1, q, -1)
        return am & (~am).any(dim=-1, keepdim=True)

    def forward(self, feats: Sequence[torch.Tensor], image_embeddings: torch.Tensor,
                image_pe: torch.Tensor, decode_last_only: bool = False):
        """Returns (cls_list, mask_list), one entry per head call (before the
        first decoder layer, then after each); with ``decode_last_only``
        every mask_list entry but the last is None."""
        b = feats[0].shape[0]
        mask_feature, memorys = self.pixel_decoder(feats)  # memorys low -> high res
        dev = mask_feature.device
        mem_tokens, mem_pos, mem_hw = [], [], []
        for i, mem in enumerate(memorys):
            h, w = mem.shape[1:3]
            tok = mem.reshape(b, h * w, -1) + self.level_embed.weight[i]
            pe = sine_positional_encoding(h, w, num_feats=self.feat_channels // 2)
            mem_tokens.append(tok)
            mem_pos.append(pe.reshape(1, h * w, -1).to(dev, tok.dtype).expand_as(tok))
            mem_hw.append((h, w))
        query_feat = self.query_feat.weight[None].expand(b, -1, -1)
        query_pos = self.query_embed.weight[None].expand(b, -1, -1)

        cls_list, mask_list = [], []

        def head(qf, hw_idx, decode):
            cls_pred, mask_pred, am = self._forward_head(
                qf, mask_feature, mem_hw[hw_idx], image_embeddings, image_pe, decode
            )
            cls_list.append(cls_pred)
            mask_list.append(mask_pred)
            return am

        layers = self.transformer_decoder.layers
        attn_mask = head(query_feat, 0, not decode_last_only)
        for i, layer in enumerate(layers):
            lvl = i % self.num_levels
            query_feat = layer(query_feat, query_pos, mem_tokens[lvl], mem_pos[lvl], attn_mask)
            attn_mask = head(query_feat, (i + 1) % self.num_levels,
                             not decode_last_only or i == len(layers) - 1)
        return cls_list, mask_list

    def predict(self, feats, image_embeddings, image_pe):
        """(class logits (B, Q, C+1), mask logits (B, Q, 4h, 4w)) of the last layer."""
        cls_list, mask_list = self(feats, image_embeddings, image_pe, decode_last_only=True)
        return cls_list[-1], mask_list[-1]
