"""SAM ViT image encoder (torch, NHWC tokens).

Counterpart of ``rsprompter_tpu/models/sam/vision_encoder.py``: 16x16 patch
embed -> abs pos-embed -> N pre-LN blocks (windowed attention except at
``global_attn_indexes``) -> 1x1 conv + LN + 3x3 conv + LN neck.

Each block runs on the port's three kernels: kernel B
(``ops.fused_mlp.ln_qkv_headmajor``) for LN1 + qkv straight off the token
grid (the window partition and its zero pad live in the kernel's row map),
kernel C (``ops.fused_vit_attention.relpos_attention``) for the attention
with the rel-pos bias, and kernel A (``ops.fused_mlp.ln_mlp_residual``) for
LN2 + MLP + residual. Each is a ``torch.autograd.Function`` whose backward
is the matching backward kernel (A', B', C'); the rel-pos factor einsum stays
in torch autograd, which gives the tables their gradients and q its extra
term, as JAX keeps ``rel_factors_pair``'s vjp outside its kernel. Weights are
cast to the activations' dtype at each use, so fp32 master parameters train
through bf16 kernels. ``impl='plain'`` runs the same block through the plain
forward versions under torch autograd (the oracle the GPU checks compare
against, forward and gradients).

``forward`` returns (neck_out (B, h, w, C_out), hidden_states): entry 0 is the
patch embedding after the pos-embed, entry i+1 the output of block i -- the
``depth + 1`` states the RSPrompter feature aggregator reads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.sam.common import Conv2d, Linear, MLPBlock, SamLayerNorm
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa
from rsprompter_tpu_torch.ops.attention import rel_pos_factors
from rsprompter_tpu_torch.ops.resize import resize


class SamPatchEmbeddings(nn.Module):
    """16x16 stride-16 conv patchifier: (B, H, W, 3) -> (B, H/16, W/16, C)."""

    def __init__(self, hidden_size: int, patch_size: int = 16, num_channels: int = 3):
        super().__init__()
        self.projection = Conv2d(num_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.projection(pixel_values)


class SamVisionAttention(nn.Module):
    """Parameters of one block's attention (qkv, proj, rel-pos tables)."""

    def __init__(self, hidden_size: int, num_heads: int, input_size: Tuple[int, int],
                 qkv_bias: bool = True, use_rel_pos: bool = True):
        super().__init__()
        head_dim = hidden_size // num_heads
        self.num_heads = num_heads
        self.qkv = Linear(hidden_size, 3 * hidden_size, bias=qkv_bias)
        self.proj = Linear(hidden_size, hidden_size)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))


class SamVisionLayer(nn.Module):
    """Pre-LN ViT block; ``window_size > 0`` attends within zero-padded windows."""

    def __init__(self, config: SamVisionConfig, window_size: int):
        super().__init__()
        c = config.hidden_size
        grid = config.grid_size
        self.window_size = window_size
        self.eps = config.layer_norm_eps
        self.layer_norm1 = SamLayerNorm(c, eps=self.eps)
        self.attn = SamVisionAttention(
            c, config.num_attention_heads,
            (window_size, window_size) if window_size else (grid, grid),
            config.qkv_bias, config.use_rel_pos,
        )
        self.layer_norm2 = SamLayerNorm(c, eps=self.eps)
        self.mlp = MLPBlock(c, config.mlp_dim)

    def forward(self, x: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        plain = impl == "plain"
        b, h, w, c = x.shape
        attn = self.attn
        nh = attn.num_heads
        win = self.window_size
        x = x.contiguous()
        dt = x.dtype
        qkv_bias = attn.qkv.bias
        if qkv_bias is None:
            qkv_bias = torch.zeros(3 * c, dtype=dt, device=x.device)
        qkv_fn = fm.ln_qkv_headmajor_plain if plain else fm.ln_qkv_headmajor
        qkv = qkv_fn(
            x, self.layer_norm1.weight, self.layer_norm1.bias, attn.qkv.weight.to(dt),
            qkv_bias.to(dt), 3 * nh, win, self.eps,
        )  # (N, 3n, S, d)
        hw = (win, win) if win else (h, w)
        n_img, _, s, d = qkv.shape
        if attn.use_rel_pos:
            fh, fw = rel_pos_factors(qkv[:, :nh], attn.rel_pos_h, attn.rel_pos_w, hw)
        else:
            fh = qkv.new_zeros((n_img, nh, s, hw[0]))
            fw = qkv.new_zeros((n_img, nh, s, hw[1]))
        attn_fn = fa.relpos_attention_plain if plain else fa.relpos_attention
        o = attn_fn(qkv, fh.contiguous(), fw.contiguous(), hw)  # (N, n, S, d)
        o = attn.proj(o.permute(0, 2, 1, 3).reshape(n_img, s, nh * d))
        o = fm.window_unpartition(o, (b, h, w), win)
        x = (x + o).reshape(-1, c).contiguous()
        mlp_fn = fm.ln_mlp_residual_plain if plain else fm.ln_mlp_residual
        mlp = self.mlp
        y = mlp_fn(
            x, self.layer_norm2.weight, self.layer_norm2.bias,
            mlp.lin1.weight.to(dt), mlp.lin1.bias.to(dt), mlp.lin2.weight.to(dt),
            mlp.lin2.bias.to(dt), self.eps,
        )
        return y.reshape(b, h, w, c)


class SamVisionNeck(nn.Module):
    """1x1 conv -> LN -> 3x3 conv -> LN to ``output_channels`` (bias-free)."""

    def __init__(self, hidden_size: int, output_channels: int):
        super().__init__()
        self.conv1 = Conv2d(hidden_size, output_channels, 1, bias=False)
        self.layer_norm1 = SamLayerNorm(output_channels)
        self.conv2 = Conv2d(output_channels, output_channels, 3, padding=1, bias=False)
        self.layer_norm2 = SamLayerNorm(output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm1(self.conv1(x))
        return self.layer_norm2(self.conv2(x))


class SamVisionEncoder(nn.Module):
    """Full SAM image encoder. ``impl``: 'kernel' (default) or 'plain'."""

    def __init__(self, config: SamVisionConfig):
        super().__init__()
        self.config = config
        self.impl = "kernel"
        self.patch_embed = SamPatchEmbeddings(
            config.hidden_size, config.patch_size, config.num_channels
        )
        if config.use_abs_pos:
            g = config.grid_size
            self.pos_embed = nn.Parameter(torch.zeros(1, g, g, config.hidden_size))
        else:
            self.pos_embed = None
        self.layers = nn.ModuleList(
            SamVisionLayer(
                config, 0 if i in config.global_attn_indexes else config.window_size
            )
            for i in range(config.num_hidden_layers)
        )
        self.neck = SamVisionNeck(config.hidden_size, config.output_channels)

    def forward(self, pixel_values: torch.Tensor):
        x = self.patch_embed(pixel_values)
        if self.pos_embed is not None:
            pe = self.pos_embed
            if pe.shape[1:3] != x.shape[1:3]:
                pe = resize(pe.float(), (1, x.shape[1], x.shape[2], pe.shape[3]), "bicubic")
            x = x + pe.to(x.dtype)
        hidden_states = [x]
        for layer in self.layers:
            x = layer(x, self.impl)
            hidden_states.append(x)
        return self.neck(x), tuple(hidden_states)
