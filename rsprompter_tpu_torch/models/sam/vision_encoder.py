"""SAM ViT image encoder (torch, NHWC tokens).

Counterpart of ``rsprompter_tpu/models/sam/vision_encoder.py``: 16x16 patch
embed -> abs pos-embed -> N pre-LN blocks (windowed attention except at
``global_attn_indexes``) -> 1x1 conv + LN + 3x3 conv + LN neck.

The config key ``attn_impl`` picks the block's route, as in JAX
(``rsprompter_tpu/apis/build.py`` reads it, ``SamVisionLayer`` branches):

* ``'fused'`` (the default): kernel B (``ops.fused_mlp.ln_qkv_headmajor``)
  for LN1 + qkv straight off the token grid (the window partition and its
  zero pad live in the kernel's row map), kernel C
  (``ops.fused_vit_attention.relpos_attention``) for the attention with the
  rel-pos bias, and kernel A (``ops.fused_mlp.ln_mlp_residual``) for LN2 +
  MLP + residual. Each is a ``torch.autograd.Function`` whose backward is
  the matching backward kernel (A', B', C'); the rel-pos factor einsum stays
  in torch autograd, which gives the tables their gradients and q its extra
  term, as JAX keeps ``rel_factors_pair``'s vjp outside its kernel. The
  route takes every SAM width: ViT-B (C 768, 12 heads of 64), ViT-L (C
  1024, 16 heads of 64) and ViT-H (C 1280, 16 heads of 80). At head dim 80
  JAX's ``'fused'`` block runs XLA attention (its Pallas attention and LN +
  qkv kernels take 64 only) beside its MLP kernel; the port runs kernels B
  and C there too, the same LN1 -> qkv -> rel-pos attention judged at the
  module boundary. The backwards A', B', C' take the same widths, so a
  ViT-L/H block on the card trains as a ViT-B one does.
* ``'flash'`` (JAX's non-fused block, ``vision_encoder.py:355-369`` and
  ``:452-456``): plain LN1, the explicit window partition zero-padded after
  LN1, kernel K12' (``ops.fused_mlp.qkv_headmajor``) for qkv, the rel-pos
  factors in fp32 cast to q's dtype, kernel C in the place of JAX's flash
  kernel (``flash_attention_rel_pos``), proj, unpartition, residual, then
  LN2 and ``MLPBlock`` in torch (JAX runs them outside any Pallas kernel on
  this route). K12''s backward is plain torch products, as in JAX. K12'
  and C take heads of 64 and 80, so the route runs at every SAM width.

``lora_rank > 0`` (the peft configs: r 16, alpha 32 on ``qkv``) adds JAX's
low-rank adapter to every block's qkv, ``qkv_lora_a`` (C, r) and
``qkv_lora_b`` (r, 3C) scaled by ``lora_alpha / r``, and takes JAX's LoRA
route on both ``attn_impl`` values: JAX runs its LN1 + qkv kernels only
without LoRA (``vision_encoder.py:389-403``, ``:321``), so LN1 and the
window partition are plain, as on ``'flash'``, and the qkv product with its
adapter is K12' (``ops.fused_mlp.qkv_headmajor_lora``); the rel-pos factors
and the MLP follow the route (kernel A on ``'fused'``, which JAX keeps with
LoRA, ``:437-451``). Kernels B and B' never run there.

Weights are cast to the activations' dtype at each use. The forward
kernels take bf16 or fp32 (their 3xTF32 variants), the backward kernels
bf16 only, so on the card an fp32 encoder that takes no gradient (SAM-det's
frozen segmentor, every predict) runs its blocks in fp32 through the fp32
kernels, as JAX runs its Pallas kernels in fp32; an fp32 encoder that takes
gradients runs them in bf16 -- the patch embedding cast before block 0, the
neck's input and the hidden states back to fp32 -- so fp32 master
parameters train through the bf16 kernels and their backwards. The plain
versions, and every route on the CPU, keep the model's dtype. ``impl='plain'`` runs either route
through the plain forward versions under torch autograd (the oracle the GPU
checks compare against, forward and gradients).

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
    """Parameters of one block's attention (qkv, proj, rel-pos tables and,
    with ``lora_rank > 0``, the qkv adapter in JAX's layout and names)."""

    def __init__(self, hidden_size: int, num_heads: int, input_size: Tuple[int, int],
                 qkv_bias: bool = True, use_rel_pos: bool = True, lora_rank: int = 0,
                 lora_alpha: float = 32.0):
        super().__init__()
        head_dim = hidden_size // num_heads
        self.num_heads = num_heads
        self.qkv = Linear(hidden_size, 3 * hidden_size, bias=qkv_bias)
        self.proj = Linear(hidden_size, hidden_size)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))
        self.lora_rank = lora_rank
        if lora_rank:
            self.lora_scale = lora_alpha / lora_rank
            self.qkv_lora_a = nn.Parameter(torch.empty(hidden_size, lora_rank))
            self.qkv_lora_b = nn.Parameter(torch.empty(lora_rank, 3 * hidden_size))
            self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The adapter's init, JAX's: a ~ N(0, 1/r), b = 0 (the block starts
        as the pretrained one)."""
        if self.lora_rank:
            self.qkv_lora_a.normal_(0.0, 1.0 / self.lora_rank)
            self.qkv_lora_b.zero_()


class SamVisionLayer(nn.Module):
    """Pre-LN ViT block; ``window_size > 0`` attends within zero-padded windows."""

    def __init__(self, config: SamVisionConfig, window_size: int,
                 attn_impl: str = "fused", lora_rank: int = 0, lora_alpha: float = 32.0):
        super().__init__()
        c = config.hidden_size
        grid = config.grid_size
        self.window_size = window_size
        self.attn_impl = attn_impl
        self.eps = config.layer_norm_eps
        self.layer_norm1 = SamLayerNorm(c, eps=self.eps)
        self.attn = SamVisionAttention(
            c, config.num_attention_heads,
            (window_size, window_size) if window_size else (grid, grid),
            config.qkv_bias, config.use_rel_pos, lora_rank, lora_alpha,
        )
        self.layer_norm2 = SamLayerNorm(c, eps=self.eps)
        self.mlp = MLPBlock(c, config.mlp_dim)

    def forward(self, x: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
        plain = impl == "plain"
        attn = self.attn
        if self.attn_impl == "fused" and not attn.lora_rank:
            x = x.contiguous()
            qkv_fn = fm.ln_qkv_headmajor_plain if plain else fm.ln_qkv_headmajor
            qkv = qkv_fn(
                x, self.layer_norm1.weight, self.layer_norm1.bias,
                attn.qkv.weight.to(x.dtype), self._qkv_bias(x), 3 * attn.num_heads,
                self.window_size, self.eps,
            )  # (N, 3n, S, d)
        else:  # plain LN1, then the window partition zero-padded after it
            z = fm.layer_norm(x, self.layer_norm1.weight, self.layer_norm1.bias, self.eps)
            qkv = self._qkv(fm.window_partition(z, self.window_size), plain)
        x = x + self._attend(qkv, x.shape[:3], plain)
        if self.attn_impl == "flash":
            return x + self.mlp(self.layer_norm2(x)).to(x.dtype)
        b, h, w, c = x.shape
        x = x.reshape(-1, c).contiguous()
        dt = x.dtype
        mlp_fn = fm.ln_mlp_residual_plain if plain else fm.ln_mlp_residual
        mlp = self.mlp
        y = mlp_fn(
            x, self.layer_norm2.weight, self.layer_norm2.bias,
            mlp.lin1.weight.to(dt), mlp.lin1.bias.to(dt), mlp.lin2.weight.to(dt),
            mlp.lin2.bias.to(dt), self.eps,
        )
        return y.reshape(b, h, w, c)

    def _qkv_bias(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.attn.qkv.bias
        if bias is None:
            return torch.zeros(self.attn.qkv.weight.shape[0], dtype=x.dtype, device=x.device)
        return bias.to(x.dtype)

    def _qkv(self, z: torch.Tensor, plain: bool) -> torch.Tensor:
        """z (N, S, C), normalised and partitioned -> head-major qkv (N, 3n,
        S, d) through K12', with the LoRA adapter where the block has one."""
        attn = self.attn
        n_img, s, c = z.shape
        dt = z.dtype
        args = (z.reshape(n_img * s, c), attn.qkv.weight.to(dt), self._qkv_bias(z))
        if attn.lora_rank:
            fn = fm.qkv_headmajor_lora_plain if plain else fm.qkv_headmajor_lora
            return fn(*args, attn.qkv_lora_a.to(dt), attn.qkv_lora_b.to(dt), attn.lora_scale,
                      3 * attn.num_heads, n_img)
        fn = fm.qkv_headmajor_plain if plain else fm.qkv_headmajor
        return fn(*args, 3 * attn.num_heads, n_img)

    def _attend(self, qkv: torch.Tensor, grid, plain: bool) -> torch.Tensor:
        """Head-major qkv -> the attention branch's output on the token grid
        (B, H, W, C): the rel-pos factors (in fp32 on ``'flash'``, as JAX's
        flash route computes them), kernel C, proj, unpartition."""
        attn = self.attn
        nh, win = attn.num_heads, self.window_size
        n_img, _, s, d = qkv.shape
        hw = (win, win) if win else tuple(grid[1:])
        if attn.use_rel_pos:
            fh, fw = rel_pos_factors(qkv[:, :nh], attn.rel_pos_h, attn.rel_pos_w, hw,
                                     fp32=self.attn_impl == "flash")
        else:
            fh = qkv.new_zeros((n_img, nh, s, hw[0]))
            fw = qkv.new_zeros((n_img, nh, s, hw[1]))
        attn_fn = fa.relpos_attention_plain if plain else fa.relpos_attention
        o = attn_fn(qkv, fh.contiguous(), fw.contiguous(), hw)  # (N, n, S, d)
        o = attn.proj(o.permute(0, 2, 1, 3).reshape(n_img, s, nh * d)).to(o.dtype)
        return fm.window_unpartition(o, tuple(grid), win)


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
    """Full SAM image encoder. ``attn_impl``: the block route, 'fused'
    (default) or 'flash'; ``impl``: 'kernel' (default) or 'plain';
    ``lora_rank`` > 0: the qkv adapter in every block."""

    def __init__(self, config: SamVisionConfig, attn_impl: str = "fused",
                 lora_rank: int = 0, lora_alpha: float = 32.0):
        super().__init__()
        if attn_impl not in ("fused", "flash"):
            raise ValueError(
                f"attn_impl={attn_impl!r}: the port's encoder routes are 'fused' "
                "(kernels A, B, C) and 'flash' (K12' and C)"
            )
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
                config, 0 if i in config.global_attn_indexes else config.window_size,
                attn_impl, lora_rank, lora_alpha,
            )
            for i in range(config.num_hidden_layers)
        )
        self.neck = SamVisionNeck(config.hidden_size, config.output_channels)

    def block_dtype(self, x: torch.Tensor) -> torch.dtype:
        """The dtype the blocks run in on the card's kernel route, given the
        patch embedding ``x``: x's, except that an fp32 encoder that takes
        gradients runs bf16 (the backward kernels take bf16 only)."""
        takes_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        return torch.bfloat16 if x.dtype == torch.float32 and takes_grad else x.dtype

    def forward(self, pixel_values: torch.Tensor):
        x = self.patch_embed(pixel_values)
        if self.pos_embed is not None:
            pe = self.pos_embed
            if pe.shape[1:3] != x.shape[1:3]:
                pe = resize(pe.float(), (1, x.shape[1], x.shape[2], pe.shape[3]), "bicubic")
            x = x + pe.to(x.dtype)
        hidden_states = [x]
        dt = x.dtype
        if self.impl == "kernel" and x.device.type != "cpu":
            x = x.to(self.block_dtype(x))
        for layer in self.layers:
            x = layer(x, self.impl)
            hidden_states.append(x.to(dt))
        return self.neck(x.to(dt)), tuple(hidden_states)
