"""RSPrompter-query head: Mask2Former decoder that prompts SAM (torch, NHWC).

Counterpart of ``rsprompter_tpu/models/dense_heads/mask2former_head.py``
(reference ``RSMask2FormerHead``, ``mmdet/rsprompter/models.py:275-658``) with
``sam_prompting`` and ``decoder_plus``: after each decoder layer every query
gives class logits, ``per_pointset_point`` sparse SAM prompts (``point_emb``
MLP with interleaved sin), and a mask-feature product ("plus" mask logits)
whose ``SamMaskEmbedding`` is its dense SAM prompt; the plus mask, resized to
the next memory level, is that layer's cross-attention mask. So the decoder
chain never reads the SAM stream, and the SAM decode runs after it: at
predict only for the last layer (``decode_last_only``); in :meth:`loss`
only for the queries the Hungarian match picks.

:meth:`loss` (JAX ``loss`` :411, ``_match_cost`` :483, ``_loss_single``
:509) runs in three phases over all 7 head calls (before the first decoder
layer, then after each), stacked:

1. each call's (B, Q, G) match cost on the plus stream, without gradient
   (classification, point-sampled BCE and dice on shared random points,
   weights ``CLS_WEIGHT`` / ``MASK_WEIGHT`` / ``DICE_WEIGHT``), then one
   host solve of all of them (``hungarian_match_batched``);
2. the matched queries' sparse and dense prompts (invalid GT clamped to
   query 0, masked out later), every call's stacked on the point-batch axis
   of ONE SAM decode. Prompts are per query, so embedding only the matched
   ones is exact (JAX embeds all and takes the matched);
3. per call: softmax CE over every query (``BG_CLS_WEIGHT`` on the
   unmatched), then BCE and dice on importance-sampled points of each
   matched GT, for the SAM stream and the plus stream. The loss names are
   JAX's: ``d0.`` ... ``d5.`` for the first six calls, none for the last.

The uniforms of the match points and of each stream's candidate and fill
points come in ``draws`` (JAX's key streams: per call ``li``, the match
points from ``split(fold_in(rng, li))[0]``, the candidates and fill points
from ``[1]``, shared by the two streams).

With ``decoder_plus=False`` (JAX :183-185, :253-259, :264-276) there is
no plus stream: each call's SAM decode of every query, its dense prompt
``no_mask_embed`` broadcast over the image, is that call's mask and the
next attention mask's source. The decoder chain runs it without gradient;
:meth:`loss` matches on those masks, then decodes the matched queries again
with gradient (phase 2 above, the prompts being per query: exact), and
takes the SAM stream's terms alone: 21 terms.

With ``sam_prompting=False`` it is the stock Mask2Former head of SAM-seg
Mask2Former (JAX :160-184, :223-231): a single ``cls_embed`` linear, the
``mask_embed`` MLP's mask logits as the prediction and the attention
source, and no SAM decoder. Its loss (JAX :411-506 with one stream) matches
on those masks and takes ``loss_cls``, ``loss_mask`` and ``loss_dice`` of
each call on the matched queries' masks: 21 terms.

Norms are flax's (eps 1e-6, fp32 output) and the head's MLPs stay fp32 as
JAX builds them without ``dtype=``; the attention projections compute in the
model's dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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
from rsprompter_tpu_torch.models.task_modules.hungarian import (
    BIG_COST,
    bce_cost,
    classification_cost,
    dice_cost,
    hungarian_match_batched,
)
from rsprompter_tpu_torch.ops.point_utils import (
    point_draw_shapes,
    sample_mask_points_bf16,
    sample_mask_points_shared,
    uncertain_point_coords,
)
from rsprompter_tpu_torch.ops.resize import resize
from rsprompter_tpu_torch.parallel.distributed import global_count

# The loss weights of JAX's head (:130-136), which no config sets.
CLS_WEIGHT = 2.0
MASK_WEIGHT = 5.0
DICE_WEIGHT = 5.0
BG_CLS_WEIGHT = 0.1


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
    def __init__(self, decoder_config: Optional[SamMaskDecoderConfig], num_classes: int = 1,
                 num_queries: int = 100, feat_channels: int = 128, out_channels: int = 256,
                 num_transformer_feat_level: int = 3, num_decoder_layers: int = 6,
                 num_heads: int = 8, feedforward_channels: int = 512,
                 per_pointset_point: int = 5, with_sincos: bool = True,
                 num_points: int = 12544, oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75, sam_prompting: bool = True,
                 decoder_plus: bool = True):
        super().__init__()
        self.sam_prompting = sam_prompting
        # each call's SAM decode of every query drives the decoder chain
        self.chain_decodes = sam_prompting and not decoder_plus
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.feat_channels = feat_channels
        self.num_levels = num_transformer_feat_level
        self.per_pointset_point = per_pointset_point
        self.with_sincos = with_sincos
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
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
        if sam_prompting:
            self.cls_embed = _mlp((feat_channels, feat_channels, num_classes + 1))
            num_sincos = 2 if with_sincos else 1
            self.point_emb = _mlp((feat_channels, feat_channels // 2, feat_channels // 2,
                                   out_channels * num_sincos * per_pointset_point))
            self.mask_decoder = SamMaskDecoder(decoder_config)
            if decoder_plus:
                self.sam_mask_embed = SamMaskEmbedding(
                    SamPromptEncoderConfig(hidden_size=decoder_config.hidden_size)
                )
            else:
                self.no_mask_embed = nn.Embedding(1, decoder_config.hidden_size)
        else:
            self.cls_embed = Fp32Linear(feat_channels, num_classes + 1)
        if not self.chain_decodes:
            self.mask_embed = _mlp((feat_channels, feat_channels, feat_channels, out_channels))

    @property
    def num_head_calls(self) -> int:
        return len(self.transformer_decoder.layers) + 1

    def draw_shapes(self, batch_size: int, max_gt: int) -> Dict[str, Tuple[int, ...]]:
        """Shapes of :meth:`loss`'s ``draws`` (uniforms in [0, 1))."""
        k_cand, k_rand = point_draw_shapes(self.num_points, self.oversample_ratio,
                                           self.importance_sample_ratio)
        n = self.num_head_calls
        return {"match": (n, batch_size, self.num_points, 2),
                "cand": (n, batch_size * max_gt, k_cand, 2),
                "rand": (n, batch_size * max_gt, k_rand, 2)}

    def _forward_head(self, decoder_out, mask_feature, attn_hw, image_embeddings, image_pe):
        """-> (class logits (B, Q, C+1), post-normed queries (B, Q, C), mask
        logits fp32, next attention mask). The masks are the mask-feature
        product's (B, Q, H4, W4), or with ``decoder_plus=False`` the SAM
        decode's of every query (B, Q, 4h, 4w), without gradient."""
        x = self.transformer_decoder.post_norm(decoder_out)
        if self.chain_decodes:
            with torch.no_grad():
                mask = self._decode(self._sparse_prompts(x),
                                    self._dense_prompts(None, image_embeddings),
                                    image_embeddings, image_pe)
        else:
            mask = torch.einsum(
                "bqc,bhwc->bqhw", self.mask_embed(x).float(), mask_feature.float()
            )
        return self.cls_embed(x), x, mask, self._next_attn_mask(mask, attn_hw)

    @staticmethod
    def _next_attn_mask(mask_plus: torch.Tensor, attn_hw: Tuple[int, int]) -> torch.Tensor:
        """(B, Q, H4, W4) logits -> (B, 1, Q, h*w) blocked entries (True): the
        antialiased bilinear resize of ``jax.image.resize``, then sigmoid < 0.5;
        a query blocked everywhere is unblocked everywhere."""
        b, q = mask_plus.shape[:2]
        with torch.no_grad():
            am = resize(mask_plus, (b, q) + tuple(attn_hw), "bilinear")
            am = (torch.sigmoid(am) < 0.5).reshape(b, 1, q, -1)
            return am & (~am).any(dim=-1, keepdim=True)

    def _sparse_prompts(self, x: torch.Tensor) -> torch.Tensor:
        """Post-normed queries (B, N, C) -> sparse prompts (B, N, K, C_sam)."""
        b, n = x.shape[:2]
        pts = self.point_emb(x).reshape(b, n, self.per_pointset_point, -1)
        if self.with_sincos:
            pts = torch.sin(pts[..., ::2]) + pts[..., 1::2]
        return pts

    def _dense_prompts(self, mask_plus: Optional[torch.Tensor],
                       image_embeddings: torch.Tensor) -> torch.Tensor:
        """Plus masks (B, N, H4, W4) -> dense prompts (B, N, h, w, C_sam); no
        gradient reaches the masks (JAX's stop_gradient, :248). Without the
        plus stream: ``no_mask_embed`` over the image, (B, h, w, C_sam)."""
        if self.chain_decodes:
            b, h, w, _ = image_embeddings.shape
            return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(b, h, w, -1)
        b, n, h4, w4 = mask_plus.shape
        dense = self.sam_mask_embed(mask_plus.detach().reshape(b * n, h4, w4, 1))
        return dense.reshape(b, n, *dense.shape[1:])

    def _decode(self, sparse, dense, image_embeddings, image_pe) -> torch.Tensor:
        """(B, N, K, C) sparse + (B, N, h, w, C) dense prompts -> SAM mask
        logits (B, N, 4h, 4w)."""
        b = sparse.shape[0]
        masks, _ = self.mask_decoder(
            image_embeddings, image_pe.expand(b, *image_pe.shape[1:]), sparse, dense
        )
        return masks[:, :, 0]

    def run_decoder(self, feats: Sequence[torch.Tensor],
                    image_embeddings: Optional[torch.Tensor] = None,
                    image_pe: Optional[torch.Tensor] = None):
        """The pixel decoder, then the query decoder chain. Returns, one
        entry per head call, class logits, post-normed queries and masks
        (:meth:`_forward_head`'s)."""
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

        cls_list, x_list, mask_list = [], [], []

        def head(qf, hw_idx):
            cls_pred, x, mask, am = self._forward_head(qf, mask_feature, mem_hw[hw_idx],
                                                       image_embeddings, image_pe)
            cls_list.append(cls_pred)
            x_list.append(x)
            mask_list.append(mask)
            return am

        attn_mask = head(query_feat, 0)
        for i, layer in enumerate(self.transformer_decoder.layers):
            lvl = i % self.num_levels
            query_feat = layer(query_feat, query_pos, mem_tokens[lvl], mem_pos[lvl], attn_mask)
            attn_mask = head(query_feat, (i + 1) % self.num_levels)
        return cls_list, x_list, mask_list

    def forward(self, feats: Sequence[torch.Tensor], image_embeddings: torch.Tensor,
                image_pe: torch.Tensor, decode_last_only: bool = False):
        """Returns (cls_list, mask_list), one entry per head call, each
        call's SAM decode over all its queries; with ``decode_last_only``
        (the plus stream's) every mask_list entry but the last is None."""
        cls_list, x_list, chain_masks = self.run_decoder(feats, image_embeddings, image_pe)
        if self.chain_decodes:  # each call's SAM decode of every query already
            return cls_list, chain_masks
        mask_list: List[Optional[torch.Tensor]] = [None] * len(cls_list)
        for i in range(len(cls_list)):
            if decode_last_only and i < len(cls_list) - 1:
                continue
            mask_list[i] = self._decode(self._sparse_prompts(x_list[i]),
                                        self._dense_prompts(chain_masks[i], image_embeddings),
                                        image_embeddings, image_pe)
        return cls_list, mask_list

    def predict(self, feats, image_embeddings, image_pe):
        """(class logits (B, Q, C+1), mask logits (B, Q, 4h, 4w)) of the last
        layer: the SAM decode's, or the stock head's mask-feature product."""
        if not self.sam_prompting:
            cls_list, _, plus_list = self.run_decoder(feats)
            return cls_list[-1], plus_list[-1]
        cls_list, mask_list = self(feats, image_embeddings, image_pe, decode_last_only=True)
        return cls_list[-1], mask_list[-1]

    # -- loss ----------------------------------------------------------------
    def loss(self, feats: Sequence[torch.Tensor], gt_labels: torch.Tensor,
             gt_masks: torch.Tensor, gt_valid: torch.Tensor, image_embeddings: torch.Tensor,
             image_pe: torch.Tensor, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """gt_labels, gt_valid (B, G); gt_masks (B, G, H, W) at the batch
        input's resolution (any dtype, 0 / 1); ``draws`` as
        :meth:`draw_shapes`. Returns the 35 loss terms of the plus stream's
        head, or the 21 of one stream (module docstring)."""
        cls_list, x_list, mask_list = self.run_decoder(feats, image_embeddings, image_pe)
        n_calls = len(cls_list)
        b, g = gt_labels.shape
        q = self.num_queries
        cls_all = torch.stack(cls_list)  # (L, B, Q, C+1)
        mask_all = torch.stack(mask_list)  # (L, B, Q, h, w)
        matched = hungarian_match_batched(
            self._match_cost(cls_all, mask_all, gt_labels, gt_masks, gt_valid,
                             draws["match"]),
            gt_valid,
        )  # (L, B, G)
        safe_q = matched.clamp(0, q - 1)
        li = torch.arange(n_calls, device=safe_q.device)[:, None, None]
        bi = torch.arange(b, device=safe_q.device)[None, :, None]
        mask_m = mask_all[li, bi, safe_q]  # (L, B, G, h, w)
        streams = [] if self.sam_prompting else [("", mask_m)]
        if self.sam_prompting:
            # the matched queries' prompts, every call on one decode's point-batch axis
            x_m = torch.stack(x_list)[li, bi, safe_q]  # (L, B, G, C)
            sparse = self._sparse_prompts(x_m.transpose(0, 1).reshape(b, n_calls * g, -1))
            plus_m = (None if self.chain_decodes else
                      mask_m.transpose(0, 1).reshape(b, n_calls * g, *mask_m.shape[-2:]))
            dense = self._dense_prompts(plus_m, image_embeddings)
            sam = self._decode(sparse, dense, image_embeddings, image_pe)  # (B, L*G, 4h, 4w)
            streams.append(("", sam.reshape(b, n_calls, g, *sam.shape[-2:]).transpose(0, 1)))
            if not self.chain_decodes:
                streams.append(("_plus", mask_m))

        per_call = {"loss_cls": self._cls_loss(cls_all, matched, gt_labels, gt_valid)}
        for suffix, masks in streams:
            loss_mask, loss_dice = self._mask_losses(masks, matched, gt_masks, gt_valid,
                                                     draws["cand"], draws["rand"])
            per_call[f"loss_mask{suffix}"] = loss_mask
            per_call[f"loss_dice{suffix}"] = loss_dice
        losses = {}
        for i in range(n_calls):
            prefix = "" if i == n_calls - 1 else f"d{i}."
            for k, v in per_call.items():
                losses[prefix + k] = v[i]
        return losses

    @torch.no_grad()
    def _match_cost(self, cls_all, mask_all, gt_labels, gt_masks, gt_valid, points):
        """(L, B, Q, G) cost: every prediction and GT of an image sampled at
        the same points ``points`` (L, B, P, 2); invalid GT cost 1e8."""
        n_calls = cls_all.shape[0]
        pred_pts = sample_mask_points_shared(mask_all, points)  # (L, B, Q, P)
        gt_pts = sample_mask_points_shared(
            gt_masks[None].expand(n_calls, *gt_masks.shape), points)
        gt_pts = (gt_pts >= 0.5).float()
        cost = (CLS_WEIGHT * classification_cost(cls_all, gt_labels)
                + MASK_WEIGHT * bce_cost(pred_pts, gt_pts)
                + DICE_WEIGHT * dice_cost(pred_pts, gt_pts))
        return torch.where(gt_valid[:, None, :], cost, BIG_COST)

    def _cls_loss(self, cls_all, matched, gt_labels, gt_valid) -> torch.Tensor:
        """(L,) weighted softmax CE over every query: matched queries take
        their GT's class, the rest the background class at ``BG_CLS_WEIGHT``."""
        n_calls, b, q = cls_all.shape[:3]
        assigned = gt_valid & (matched >= 0)
        scatter_q = torch.where(assigned, matched.clamp(0, q - 1), q)
        labels = torch.full((n_calls, b, q + 1), self.num_classes, dtype=torch.long,
                            device=cls_all.device)
        labels.scatter_(2, scatter_q, gt_labels.long().expand_as(scatter_q))
        labels = labels[..., :q]
        logp = torch.log_softmax(cls_all.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        cw = torch.where(labels == self.num_classes, BG_CLS_WEIGHT, 1.0)
        return CLS_WEIGHT * (nll * cw).sum((1, 2)) / global_count(cw.sum((1, 2)))

    def _mask_losses(self, masks, matched, gt_masks, gt_valid, cand, rand):
        """masks (L, B, G, h, w): each GT's matched mask logits, per call.
        Returns (L,) point-sampled BCE and dice (eps 1), each at its
        weight, over the GT that are valid and matched."""
        n_calls, b, g, h, w = masks.shape
        flat = masks.reshape(n_calls * b * g, h, w)
        coords = uncertain_point_coords(
            flat, cand.reshape(n_calls * b * g, *cand.shape[-2:]),
            rand.reshape(n_calls * b * g, *rand.shape[-2:]), self.num_points,
            self.importance_sample_ratio,
        )
        pred = sample_mask_points_bf16(flat, coords).reshape(n_calls, b * g, -1)
        gt = gt_masks.reshape(1, b * g, *gt_masks.shape[-2:])
        tgt = sample_mask_points_bf16(gt.expand(n_calls, *gt.shape[1:]),
                                      coords.reshape(n_calls, b * g, -1, 2))
        tgt = (tgt >= 0.5).float()
        wgt = (gt_valid & (matched >= 0)).reshape(n_calls, b * g).float()
        num_total = global_count(gt_valid.sum().float())
        p = torch.sigmoid(pred)
        dice = 1 - (2 * (p * tgt).sum(-1) + 1.0) / (p.sum(-1) + tgt.sum(-1) + 1.0)
        loss_dice = DICE_WEIGHT * (dice * wgt).sum(-1) / num_total
        bce = (pred.clamp(min=0) - pred * tgt + torch.log1p(torch.exp(-pred.abs()))).mean(-1)
        loss_mask = MASK_WEIGHT * (bce * wgt).sum(-1) / global_count(wgt.sum(-1))
        return loss_mask, loss_dice
