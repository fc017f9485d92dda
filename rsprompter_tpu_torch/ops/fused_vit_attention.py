"""Kernel C: SAM ViT attention with the decomposed rel-pos bias, and its
backward C'.

``relpos_attention`` (``csrc/relpos_attention.cu``) replaces the TPU kernels
of ``rsprompter_tpu/ops/fused_vit_attention.py``: ``_window_kernel_pair``
(windowed layers), ``_global_kernel_pair_tiled`` (global layers, inference
default) and ``_global_kernel_pair`` (exact-softmax variant). It is one
FlashAttention-3-style kernel (TMA, wgmma) with an exact online softmax; the TPU's +-60 logit clamp
is dropped (PARITY.md deviation 8). Its backward C'
(``csrc/relpos_attention_bwd.cu``) replaces ``_window_bwd_kernel_pair`` and
``_global_bwd_kernel_pair``: from the forward's output and row log-sum-exp it
returns dqkv and the factors' gradients dfh, dfw.

The rel-pos factors stay a torch einsum outside the kernel, as JAX computes
them outside its Pallas kernel (``rel_factors_pair``): fh (N, n, S, h) and
fw (N, n, S, w); the kernel rebuilds bias[q, k] = fh[q, k // w] + fw[q, k % w]
per key tile, and torch autograd carries dfh / dfw on to the rel-pos tables
and q. Bound on the H100: tensor-core operations for the 4096-token global
layers (103 GFLOP per ViT-B layer at batch 2), device-memory bytes for the
196-token windows (about 70 MB per layer).

Both take heads of d = 64 and 80 (``HEAD_DIMS``, the scale d^-0.5): ViT-H's
16 heads of 80, where JAX runs XLA attention and its autodiff (its Pallas
kernels take 64 only). ``relpos_attention_route`` says which of kernel C's
two paths (window, global) a grid takes at a head dim; C' takes every grid
kernel C takes, up to 64 x 64, at both head dims.

It also serves two more TPU kernels, at their own call sites: the encoder's
``'flash'`` route runs it where JAX runs ``flash_attention.py``'s
``_fwd_kernel`` / ``_fwd_kernel_smallseq`` (K10: exact softmax, p rounded to
the input dtype before PV, normalised after, as here), and at an odd head
count it computes ``fused_vit_attention.py``'s per-head ``_window_kernel`` /
``_global_kernel`` (K11; the clamp dropped as above). Launches at an odd head
count are counted under their own variant (``window/odd``, ``global/odd``).

On fp32 qkv and factors (an fp32 model, no gradient) kernel C launches its
fp32 variant (``csrc/relpos_attention_f32.cu``, counted with ``/f32`` after
the variant's name): 3xTF32 products on wgmma ``.tf32``, an exact online
softmax in fp32 over 64-key tiles, one path for every grid; no row
log-sum-exp, as C' takes bf16 only.

``relpos_attention`` is a ``torch.autograd.Function``: kernel forward and
backward for CUDA tensors, the plain versions for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rsprompter_tpu_torch.ops._cuda import (
    CudaKernel, backward_bf16, check_cuda_tensor, operand_dtype, ptr,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_NULL = ctypes.c_void_p(None)

RELPOS_ATTENTION = CudaKernel(
    "relpos_attention", "relpos_attention.cu", "rsp_relpos_attention",
    [_P] * 5 + [_I] * 6 + [_F, _P],
    f32=("relpos_attention_f32.cu", "rsp_relpos_attention_f32"),
)
RELPOS_ATTENTION_BWD = CudaKernel(
    "relpos_attention_bwd", "relpos_attention_bwd.cu", "rsp_relpos_attention_bwd",
    [_P] * 12 + [_I] * 7 + [_F, _P],
)
# the depth of C''s scratch F and E (a query of the built library, no launch)
RELPOS_ATTENTION_BWD_DEPTH = CudaKernel(
    "relpos_attention_bwd_depth", "relpos_attention_bwd.cu", "rsp_relpos_attention_bwd_depth",
    [_I] * 3,
)
# which of kernel C's paths a shape takes (a query of the built library, no launch)
RELPOS_ATTENTION_ROUTE = CudaKernel(
    "relpos_attention_route", "relpos_attention.cu", "rsp_relpos_attention_route", [_I] * 4,
)
HEAD_DIMS = (64, 80)  # the head dims of kernel C and C'


def relpos_attention_route(hw: Tuple[int, int], d: int) -> str:
    """The path kernel C takes for an h x w grid at head dim d, as its
    dispatcher decides it: 'window' (one tile of every key, the bias as a
    product) or 'global' (key tiles streamed with an online softmax). Asks
    the built library, so on the card only."""
    route = RELPOS_ATTENTION_ROUTE.load()(hw[0] * hw[1], hw[0], hw[1], d)
    if route < 0:
        raise ValueError(f"relpos_attention: no path for grid {hw} at head dim {d}")
    return "window" if route else "global"


def _variant(s: int, heads: int) -> str:
    return ("global" if s > 512 else "window") + ("/odd" if heads % 2 else "")


def _biased_scores(q, k, fh, fw):
    """fp32 q k^T * d^-0.5 + fh[q, k // w] + fw[q, k % w]: (N, n, S, S)."""
    nb, n, s, d = q.shape
    scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * d ** -0.5
    bias = fh.float()[..., :, None] + fw.float()[..., None, :]
    return scores + bias.reshape(nb, n, s, s)


def relpos_attention_plain(
    qkv: torch.Tensor, fh: torch.Tensor, fw: torch.Tensor, hw: Tuple[int, int]
) -> torch.Tensor:
    """qkv (N, 3n, S, d), fh (N, n, S, h), fw (N, n, S, w) -> (N, n, S, d):
    materialised fp32 scores + bias, exact softmax, output in qkv's dtype."""
    n = qkv.shape[1] // 3
    q, k, v = qkv[:, :n], qkv[:, n : 2 * n], qkv[:, 2 * n :]
    probs = torch.softmax(_biased_scores(q, k, fh, fw), dim=-1)
    return torch.einsum("bnqk,bnkd->bnqd", probs, v.float()).to(qkv.dtype)


def relpos_attention_bwd_plain(qkv, fh, fw, dout, hw: Tuple[int, int]):
    """Backward of :func:`relpos_attention_plain`, step by step as the JAX
    kernel body ``_attend_one_bwd`` computes it: exact P recomputed in fp32,
    delta = rowsum(dP * P), dS = P (dP - delta); dS and P cast to qkv's dtype
    before their products; dfh / dfw are dS's sums over each key row / key
    column (JAX's dS E^T). Returns (dqkv, dfh, dfw) in the inputs' dtypes."""
    h, w = hw
    dt = qkv.dtype
    n = qkv.shape[1] // 3
    q, k, v = qkv[:, :n], qkv[:, n : 2 * n], qkv[:, 2 * n :]
    nb, _, s, d = q.shape
    scale = d ** -0.5
    p = torch.softmax(_biased_scores(q, k, fh, fw), dim=-1)
    do = dout.to(dt).float()
    dp = torch.einsum("bnqd,bnkd->bnqk", do, v.float())
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bnqk,bnkd->bnqd", ds, k.float()) * scale
    dk = torch.einsum("bnqk,bnqd->bnkd", ds, q.float()) * scale
    dv = torch.einsum("bnqk,bnqd->bnkd", p.to(dt).float(), do)
    dsg = ds.reshape(nb, n, s, h, w)
    return (torch.cat([dq, dk, dv], dim=1).to(dt), dsg.sum(dim=-1).to(fh.dtype),
            dsg.sum(dim=-2).to(fw.dtype))


def _check_attention_args(qkv, fh, fw, hw):
    """Kernel C's (and C''s) arguments: qkv and the factors all bf16 or all
    fp32. Returns (nb, n, s, d, dtype)."""
    dt = operand_dtype("relpos_attention", qkv, fh, fw)
    h, w = hw
    nb, n3, s, d = qkv.shape
    n = n3 // 3
    if d not in HEAD_DIMS:
        raise ValueError(f"relpos_attention: head dim {d} is not one of {HEAD_DIMS}")
    check_cuda_tensor("qkv", qkv, dt, (nb, 3 * n, h * w, d))
    check_cuda_tensor("fh", fh, dt, (nb, n, s, h))
    check_cuda_tensor("fw", fw, dt, (nb, n, s, w))
    if h > 64 or w > 64:
        raise ValueError(f"relpos_attention: grid {h}x{w} exceeds 64x64")
    return nb, n, s, d, dt


def _relpos_attention_fwd(qkv, fh, fw, hw, with_lse: bool):
    """(out, row log-sum-exp or None); the log-sum-exp only from the kernel."""
    if qkv.device.type == "cpu":
        return relpos_attention_plain(qkv, fh, fw, hw), None
    nb, n, s, d, dt = _check_attention_args(qkv, fh, fw, hw)
    f32 = dt == torch.float32
    if with_lse:
        backward_bf16("relpos_attention", dt)
    out = torch.empty((nb, n, s, d), dtype=dt, device=qkv.device)
    lse = torch.empty((nb, n, s), dtype=torch.float32, device=qkv.device) if with_lse else None
    RELPOS_ATTENTION.launch(
        ptr(qkv), ptr(fh), ptr(fw), ptr(out), ptr(lse) if with_lse else _NULL,
        nb, n, s, hw[0], hw[1], d, d ** -0.5, variant=_variant(s, n), f32=f32,
    )
    return out, lse


def relpos_attention_bwd(qkv, fh, fw, out, lse, dout, hw: Tuple[int, int]):
    """Kernel C' on CUDA tensors, given the forward's output and row
    log-sum-exp; the plain backward on the CPU. Returns (dqkv, dfh, dfw)."""
    if qkv.device.type == "cpu":
        return relpos_attention_bwd_plain(qkv, fh, fw, dout, hw)
    nb, n, s, d, dt = _check_attention_args(qkv, fh, fw, hw)
    backward_bf16("relpos_attention_bwd", dt)
    check_cuda_tensor("out", out, torch.bfloat16, (nb, n, s, d))
    check_cuda_tensor("dout", dout, torch.bfloat16, (nb, n, s, d))
    check_cuda_tensor("lse", lse, torch.float32, (nb, n, s))
    dqkv = torch.empty_like(qkv)
    dfh = torch.empty_like(fh)
    dfw = torch.empty_like(fw)
    # scratch (csrc/relpos_attention_bwd.cu's header): delta; F, nfb columns
    # (whole 128-byte tiles, as many as the library asks for); the group
    # matrix E over the keys padded to whole 64-key tiles
    nfb = RELPOS_ATTENTION_BWD_DEPTH.load()(hw[0], hw[1], d)
    sp = -(-s // 64) * 64
    delta = torch.empty((nb, n, s), dtype=torch.float32, device=qkv.device)
    fcat = torch.empty((nb, n, s, nfb), dtype=torch.bfloat16, device=qkv.device)
    groups = torch.empty((sp, nfb), dtype=torch.bfloat16, device=qkv.device)
    RELPOS_ATTENTION_BWD.launch(
        ptr(qkv), ptr(fh), ptr(fw), ptr(out), ptr(lse), ptr(dout), ptr(dqkv),
        ptr(dfh), ptr(dfw), ptr(delta), ptr(fcat), ptr(groups),
        nb, n, s, hw[0], hw[1], d, sp, d ** -0.5, variant=_variant(s, n),
    )
    return dqkv, dfh, dfw


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, fh, fw, hw):
        out, lse = _relpos_attention_fwd(qkv, fh, fw, hw, any(ctx.needs_input_grad))
        ctx.save_for_backward(qkv, fh, fw, out, lse)
        ctx.hw = hw
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, fh, fw, out, lse = ctx.saved_tensors
        return (*relpos_attention_bwd(qkv, fh, fw, out, lse, dout.contiguous(), ctx.hw),
                None)


def relpos_attention(qkv: torch.Tensor, fh: torch.Tensor, fw: torch.Tensor,
                     hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel C on CUDA tensors (qkv and factors all bf16, or all fp32 for
    the 3xTF32 variant; head dim 64 or 80, h and w <= 64), with C' as its
    backward (bf16 only); the plain versions on the CPU. Recording a graph
    on the card, fp32 operands raise before any launch."""
    if torch.is_grad_enabled() and (qkv.requires_grad or fh.requires_grad or fw.requires_grad):
        if qkv.device.type != "cpu":
            backward_bf16("relpos_attention", operand_dtype("relpos_attention", qkv, fh, fw))
        return _RelposAttention.apply(qkv, fh, fw, hw)
    return _relpos_attention_fwd(qkv, fh, fw, hw, False)[0]  # no graph to record
