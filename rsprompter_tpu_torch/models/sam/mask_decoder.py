"""SAM mask decoder: two-way transformer + upscaler + hypernetworks (torch).

Counterpart of ``rsprompter_tpu/models/sam/mask_decoder.py`` (HF
``SamMaskDecoder``) in the plain layout: prompts flatten into the batch and
the image side is broadcast to every prompt from the start. The JAX module's
TPU layouts (block-diagonal head packing, the packed upscaler, the shared
first block) compute the same math and are not carried over.

Tokens = [iou_token, mask_tokens, sparse prompts]; ``multimask_output``
selects mask slice 1: (else 0:1). The dense prompt is one per image (B, h, w,
C) or one per prompt (B, P, h, w, C), the query head's ``decoder_plus`` case.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.models.sam.common import (
    FastConvTranspose2x2,
    Linear,
    MLPBlock,
    SamFeedForward,
    SamLayerNorm,
)
from rsprompter_tpu_torch.models.sam.configs import SamMaskDecoderConfig


class SamAttention(nn.Module):
    """Multi-head attention with channel downsampling (internal = C / rate)."""

    def __init__(self, config: SamMaskDecoderConfig, downsample_rate: int = 1):
        super().__init__()
        c = config.hidden_size
        internal = c // downsample_rate
        self.num_heads = config.num_attention_heads
        self.q_proj = Linear(c, internal)
        self.k_proj = Linear(c, internal)
        self.v_proj = Linear(c, internal)
        self.out_proj = Linear(internal, c)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        return x.reshape(b, t, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, query, key, value):
        """(B, Tq, C), (B, Tk, C), (B, Tk, C) -> (B, Tq, C)."""
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        hd = q.shape[-1]
        scores = torch.einsum("bntd,bnsd->bnts", q.float(), k.float()) / hd ** 0.5
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bnts,bnsd->bntd", probs, v)
        b, _, t, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, t, -1))


class SamTwoWayAttentionBlock(nn.Module):
    def __init__(self, config: SamMaskDecoderConfig, skip_first_layer_pe: bool = False):
        super().__init__()
        c, eps = config.hidden_size, config.layer_norm_eps
        rate = config.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamAttention(config, 1)
        self.layer_norm1 = SamLayerNorm(c, eps)
        self.cross_attn_token_to_image = SamAttention(config, rate)
        self.layer_norm2 = SamLayerNorm(c, eps)
        self.mlp = MLPBlock(c, config.mlp_dim)
        self.layer_norm3 = SamLayerNorm(c, eps)
        self.cross_attn_image_to_token = SamAttention(config, rate)
        self.layer_norm4 = SamLayerNorm(c, eps)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class SamTwoWayTransformer(nn.Module):
    def __init__(self, config: SamMaskDecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            SamTwoWayAttentionBlock(config, skip_first_layer_pe=(i == 0))
            for i in range(config.num_hidden_layers)
        )
        self.final_attn_token_to_image = SamAttention(config, config.attention_downsample_rate)
        self.layer_norm_final_attn = SamLayerNorm(config.hidden_size, eps=1e-5)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        """(N, T, C) tokens; (N, S, C) image and PE -> ((N, T, C), (N, S, C))."""
        queries, keys = point_embeddings, image_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, image_pe)
        q = queries + point_embeddings
        k = keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.layer_norm_final_attn(queries), keys


class SamMaskDecoder(nn.Module):
    """Masks (B, P, M, 4h, 4w) and IoU (B, P, M) from per-image prompts."""

    def __init__(self, config: SamMaskDecoderConfig):
        super().__init__()
        c = config.hidden_size
        self.config = config
        self.num_mask_tokens = config.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.transformer = SamTwoWayTransformer(config)
        self.upscale_conv1 = FastConvTranspose2x2(c, c // 4)
        self.upscale_layer_norm = SamLayerNorm(c // 4)
        self.upscale_conv2 = FastConvTranspose2x2(c // 4, c // 8)
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamFeedForward(c, c, c // 8, 3) for _ in range(self.num_mask_tokens)
        )
        self.iou_prediction_head = SamFeedForward(
            c, config.iou_head_hidden_dim, self.num_mask_tokens, config.iou_head_depth
        )

    def forward(
        self,
        image_embeddings: torch.Tensor,  # (B, h, w, C)
        image_positional_embeddings: torch.Tensor,  # (B, h, w, C)
        sparse_prompt_embeddings: torch.Tensor,  # (B, P, T, C)
        dense_prompt_embeddings: torch.Tensor,  # (B, h, w, C) or (B, P, h, w, C)
        multimask_output: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, c = image_embeddings.shape
        p = sparse_prompt_embeddings.shape[1]
        m = self.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat(
            [out_tokens[None, None].expand(b, p, m + 1, c),
             sparse_prompt_embeddings.to(out_tokens.dtype)], dim=2,
        )
        t = tokens.shape[2]
        if dense_prompt_embeddings.ndim == 5:
            img = (image_embeddings[:, None] + dense_prompt_embeddings).reshape(b * p, h * w, c)
        else:
            img = (image_embeddings + dense_prompt_embeddings).reshape(b, 1, h * w, c)
            img = img.expand(b, p, h * w, c).reshape(b * p, h * w, c)
        pe = image_positional_embeddings.reshape(b, 1, h * w, c)
        pe = pe.expand(b, p, h * w, c).reshape(b * p, h * w, c)
        point_emb, img_emb = self.transformer(tokens.reshape(b * p, t, c), img, pe)
        iou_token_out = point_emb[:, 0]
        mask_tokens_out = point_emb[:, 1 : 1 + m]

        up = self.upscale_conv1(img_emb.reshape(b * p, h, w, c))
        up = F.gelu(self.upscale_layer_norm(up))
        up = F.gelu(self.upscale_conv2(up))  # (B*P, 4h, 4w, C/8)
        sel = slice(1, None) if multimask_output else slice(0, 1)
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1,
        )[:, sel]  # (B*P, M', C/8)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper_in.float(), up.float())
        masks = masks.reshape(b, p, -1, 4 * h, 4 * w)
        iou = self.iou_prediction_head(iou_token_out).reshape(b, p, m)
        return masks, iou[:, :, sel]
