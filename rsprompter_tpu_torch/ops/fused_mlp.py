"""Kernels A and B of the ViT trunk and their backwards, each beside its
plain torch version.

Kernel A, ``ln_mlp_residual`` (``csrc/ln_mlp_residual.cu``), replaces the TPU
kernel ``rsprompter_tpu/ops/fused_mlp.py:_kernel`` (``fused_mlp_residual``):
x + fc2(gelu_erf(fc1(LN(x)))), tensor-core bound on the H100 (77.3 GFLOP per
ViT-B layer at batch 2). It is three launches: kernel B's row pass
``ln_rows`` for the LN (counted as ``LN_ROWS`` variant ``mlp``), then two
wgmma GEMMs of one entry point, fc1 with its bias and GELU and fc2 with its
bias and the residual (counted as ``LN_MLP_RESIDUAL`` variants ``fc1`` and
``fc2``); the (T, 4C) hidden activation goes through device memory in bf16,
at the rounding point JAX's kernel has (see the source note). Its backward
A' (``csrc/ln_mlp_residual_bwd.cu``) replaces ``_mlp_bwd_kernel``: one
entry point, counted once per call as ``LN_MLP_RESIDUAL_BWD``, that makes
six device launches, its five products on kernel A's TMA + wgmma mainloop
(``csrc/wgmma_gemm.cuh``) with each operand read as stored, K-major or
MN-major; ``wgmma_gemm_f32`` runs that mainloop alone for the card tests.

Kernel B, ``ln_qkv_headmajor`` (``csrc/ln_qkv_headmajor.cu``), replaces
``_ln_qkv_kernel`` (``fused_ln_qkv``, global layers) and
``_strip_qkv_kernel`` (``fused_qkv_window_pair``, windowed layers): LN then
the qkv product, written head-major (N, 3n, S, d). It is two launches: the
row pass ``ln_rows`` (LN, window partition and zero pad into z, counted as
``LN_ROWS``) and the wgmma GEMM that K12' is too (counted as
``LN_QKV_HEADMAJOR`` when kernel B launches it). Tensor-core bound (29 GFLOP
per layer). Its backward B' (``csrc/ln_qkv_headmajor_bwd.cu``) replaces
``_ln_qkv_bwd_kernel`` and ``_strip_qkv_bwd_kernel``: one entry point,
counted once per call as ``LN_QKV_HEADMAJOR_BWD``, that makes five device
launches (a copy of dy to token-major rows, then A''s row kernels around one
launch of both products on the same mainloop) and takes C a multiple of 256.

Kernel K12', ``qkv_headmajor`` (the same GEMM), replaces
``_qkv_pair_kernel`` (``fused_qkv_pair``): flat tokens (N*S, C) -> x.W + b
head-major (N, 3n, S, d). The encoder's ``'flash'`` route runs it. Its
backward is plain torch products on every device, as JAX's
``_qkv_pair_bwd_vjp`` leaves it to XLA.

The public functions are ``torch.autograd.Function``s: their forward is the
kernel, their backward the backward kernel, for CUDA tensors; for tensors on
the CPU both are the plain versions. A CUDA tensor gets the kernel or an
exception, never a plain fallback. Rounding points follow the JAX kernels:
LN statistics in fp32 with the normalised row cast to the input dtype, each
product accumulated in fp32 and cast before its bias add, exact (erf) GELU in
fp32; in the backwards the gradient of the hidden activation (and the
attention's dS) is cast to the input dtype before its products.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rsprompter_tpu_torch.ops._cuda import CudaKernel, check_cuda_tensor, ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# kernel A's two products, counted apart by variant ('fc1', 'fc2')
LN_MLP_RESIDUAL = CudaKernel(
    "ln_mlp_residual", "ln_mlp_residual.cu", "rsp_mlp_gemm", [_P] * 5 + [_I] * 4 + [_P],
)
# A': one count per call (six device launches inside, see its source)
LN_MLP_RESIDUAL_BWD = CudaKernel(
    "ln_mlp_residual_bwd", "ln_mlp_residual_bwd.cu", "rsp_ln_mlp_residual_bwd",
    [_P] * 20 + [_I] * 3 + [_F, _P],
)
# A''s GEMM mainloop alone, launched only by the card tests of its layouts
WGMMA_GEMM = CudaKernel(
    "wgmma_gemm", "ln_mlp_residual_bwd.cu", "rsp_wgmma_gemm_f32", [_P] * 3 + [_I] * 6 + [_P],
)
WGMMA_GEMM_FORMS = ((False, False, 256), (False, True, 256), (False, True, 128),
                    (True, True, 256))
LN_ROWS = CudaKernel(
    "ln_rows", "ln_qkv_headmajor.cu", "rsp_ln_rows", [_P] * 4 + [_I] * 5 + [_F, _P],
)
# kernel B's GEMM and K12' are one entry point, counted apart by call site
LN_QKV_HEADMAJOR = CudaKernel(
    "ln_qkv_headmajor", "ln_qkv_headmajor.cu", "rsp_qkv_headmajor",
    [_P] * 4 + [_I] * 4 + [_P],
)
QKV_HEADMAJOR = CudaKernel(
    "qkv_headmajor", "ln_qkv_headmajor.cu", "rsp_qkv_headmajor",
    [_P] * 4 + [_I] * 4 + [_P],
)
# B': one count per call (five device launches inside, three without LN)
LN_QKV_HEADMAJOR_BWD = CudaKernel(
    "ln_qkv_headmajor_bwd", "ln_qkv_headmajor_bwd.cu", "rsp_ln_qkv_headmajor_bwd",
    [_P] * 15 + [_I] * 6 + [_F, _P],
)
_NULL = ctypes.c_void_p(None)
_DY_PART_ROWS = 64  # B''s dy pass: rows per partial column sum of db
_LN_PART_ROWS = 16  # the LN backward's rows per partial column sum


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """Last-axis LayerNorm with fp32 statistics; output in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _ln_stats(xf: torch.Tensor, eps: float):
    """fp32 (xhat, rstd) of the last axis (JAX ``_ln_stats``)."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def _ln_bwd(dz: torch.Tensor, scale: torch.Tensor, xhat: torch.Tensor, rstd):
    """LN backward given its stats (JAX ``_ln_bwd_block``), all fp32 and
    (rows, C): returns (dx, dscale, dbias)."""
    dscale = (dz * xhat).sum(dim=0)
    dbias = dz.sum(dim=0)
    dxhat = dz * scale
    dx = rstd * (
        dxhat - dxhat.mean(dim=-1, keepdim=True)
        - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)
    )
    return dx, dscale, dbias


def gelu_grad(hf: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact GELU in fp32: Phi(h) + h * phi(h)."""
    cdf = 0.5 * (1.0 + torch.erf(hf * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * hf * hf) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + hf * pdf


def _bwd_scratch(device, *shapes_dtypes):
    return [torch.empty(s, dtype=d, device=device) for s, d in shapes_dtypes]


# --------------------------------------------------------------------------
# Kernel A and A'
# --------------------------------------------------------------------------


def ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """x (T, C) -> x + fc2(gelu(fc1(LN(x)))); w1 (M, C), w2 (C, M) as in
    ``nn.Linear``. Computes in x's dtype with the JAX kernel's rounding."""
    dt = x.dtype
    z = layer_norm(x, ln_w, ln_b, eps)
    h = (z @ w1.to(dt).t()) + b1.to(dt)
    g = F.gelu(h.float(), approximate="none").to(dt)
    return x + (g @ w2.to(dt).t()) + b2.to(dt)


def ln_mlp_residual_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, dout,
                              eps: float = 1e-6):
    """Backward of :func:`ln_mlp_residual_plain`, step by step as the JAX
    kernel body ``_mlp_bwd_kernel`` computes it. Returns (dx, dln_w, dln_b,
    dw1, db1, dw2, db2), each in its input's dtype."""
    dt = x.dtype
    xhat, rstd = _ln_stats(x.float(), eps)
    z = (xhat * ln_w.float() + ln_b.float()).to(dt)
    h = (z.float() @ w1.to(dt).float().t()).to(dt) + b1.to(dt)
    hf = h.float()
    gel = F.gelu(hf, approximate="none").to(dt)
    do = dout.to(dt)
    dgl = do.float() @ w2.to(dt).float()  # (T, M)
    dw2 = do.float().t() @ gel.float()  # (C, M)
    db2 = do.float().sum(dim=0)
    dh = (dgl * gelu_grad(hf)).to(dt)
    dw1 = dh.float().t() @ z.float()  # (M, C)
    db1 = dh.float().sum(dim=0)
    dz = dh.float() @ w1.to(dt).float()  # (T, C)
    dx_ln, dsc, dbi = _ln_bwd(dz, ln_w.float(), xhat, rstd)
    dx = (do.float() + dx_ln).to(dt)
    return (dx, dsc.to(ln_w.dtype), dbi.to(ln_b.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def _check_mlp_args(x, ln_w, ln_b, w1, b1, w2, b2):
    t, c = x.shape
    m = w1.shape[0]
    bf = torch.bfloat16
    check_cuda_tensor("x", x, bf, (t, c))
    check_cuda_tensor("ln_w", ln_w, torch.float32, (c,))
    check_cuda_tensor("ln_b", ln_b, torch.float32, (c,))
    check_cuda_tensor("w1", w1, bf, (m, c))
    check_cuda_tensor("b1", b1, bf, (m,))
    check_cuda_tensor("w2", w2, bf, (c, m))
    check_cuda_tensor("b2", b2, bf, (c,))
    if c != 768 or m % 64:  # ViT-B's width; ViT-L/H come with their checks
        raise ValueError(f"ln_mlp_residual: unsupported widths C={c}, M={m}")
    return t, c, m


def _ln_mlp_residual_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    t, c, m = _check_mlp_args(x, ln_w, ln_b, w1, b1, w2, b2)
    z = torch.empty_like(x)
    LN_ROWS.launch(ptr(x), ptr(ln_w), ptr(ln_b), ptr(z), 1, 1, t, c, 0, eps, variant="mlp")
    hid = torch.empty((t, m), dtype=torch.bfloat16, device=x.device)
    LN_MLP_RESIDUAL.launch(ptr(z), ptr(w1), ptr(b1), _NULL, ptr(hid), t, m, c, 0,
                           variant="fc1")
    out = torch.empty_like(x)
    LN_MLP_RESIDUAL.launch(ptr(hid), ptr(w2), ptr(b2), ptr(x), ptr(out), t, c, m, 1,
                           variant="fc2")
    return out


def ln_mlp_residual_bwd(x, ln_w, ln_b, w1, b1, w2, b2, dout, eps: float = 1e-6):
    """Kernel A' on CUDA tensors (the plain backward on the CPU): the
    gradients of :func:`ln_mlp_residual` given dO."""
    if x.device.type == "cpu":
        return ln_mlp_residual_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, dout, eps)
    t, c, m = _check_mlp_args(x, ln_w, ln_b, w1, b1, w2, b2)
    check_cuda_tensor("dout", dout, torch.bfloat16, (t, c))
    f32, bf = torch.float32, torch.bfloat16
    parts = -(-t // 128) * m + -(-t // 16) * 3 * c  # db1's, then dgamma/dbeta/db2's
    dx, dg, dbb, dw1, db1, dw2, db2, z, stats, hg, dh, dz, part = _bwd_scratch(
        x.device, ((t, c), bf), ((c,), f32), ((c,), f32), ((m, c), bf), ((m,), bf),
        ((c, m), bf), ((c,), bf), ((t, c), bf), ((2, t), f32), ((t, m), bf), ((t, m), bf),
        ((t, c), f32), ((parts,), f32),
    )
    LN_MLP_RESIDUAL_BWD.launch(
        ptr(x), ptr(ln_w), ptr(ln_b), ptr(w1), ptr(b1), ptr(w2), ptr(dout),
        ptr(dx), ptr(dg), ptr(dbb), ptr(dw1), ptr(db1), ptr(dw2), ptr(db2),
        ptr(z), ptr(stats), ptr(hg), ptr(dh), ptr(dz), ptr(part), t, c, m, eps,
    )
    return dx, dg, dbb, dw1, db1, dw2, db2


def wgmma_gemm_f32_plain(a, b, a_mn: bool, b_mn: bool) -> torch.Tensor:
    """A . B^T in fp32, A = ``a`` (rows, K) or, with ``a_mn``, ``a.t()`` of
    ``a`` stored (K, rows); B = ``b`` (cols, K) or ``b.t()`` of (K, cols)."""
    a = a.float().t() if a_mn else a.float()
    b = b.float().t() if b_mn else b.float()
    return a @ b.t()


def wgmma_gemm_f32(a, b, a_mn: bool, b_mn: bool, bn: int = 256) -> torch.Tensor:
    """Kernel A''s GEMM mainloop alone, on its operand layouts (the tests'
    surface; the plain version on the CPU): see :func:`wgmma_gemm_f32_plain`.
    ``(a_mn, b_mn, bn)`` is one of the forms A' runs: (False, False, 256),
    (False, True, 256), (False, True, 128), (True, True, 256)."""
    if (a_mn, b_mn, bn) not in WGMMA_GEMM_FORMS:
        raise ValueError(f"wgmma_gemm_f32: no form {(a_mn, b_mn, bn)}")
    if a.device.type == "cpu":
        return wgmma_gemm_f32_plain(a, b, a_mn, b_mn)
    check_cuda_tensor("a", a, torch.bfloat16)
    check_cuda_tensor("b", b, torch.bfloat16)
    rows, k = (a.shape[1], a.shape[0]) if a_mn else tuple(a.shape)
    cols, kb = (b.shape[1], b.shape[0]) if b_mn else tuple(b.shape)
    if kb != k:
        raise ValueError(f"wgmma_gemm_f32: K of a ({k}) and b ({kb}) differ")
    out = torch.empty((rows, cols), dtype=torch.float32, device=a.device)
    WGMMA_GEMM.launch(ptr(a), ptr(b), ptr(out), rows, cols, k, int(a_mn), int(b_mn), bn)
    return out


class _LnMlpResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return _ln_mlp_residual_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, dout):
        grads = ln_mlp_residual_bwd(*ctx.saved_tensors, dout.contiguous(), ctx.eps)
        return (*grads, None)


def ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """Kernel A on CUDA tensors (bf16 x and weights, fp32 LN params), with
    A' as its backward; the plain versions on the CPU."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_w, ln_b, w1, b1, w2, b2)):
        return _LnMlpResidual.apply(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    return _ln_mlp_residual_fwd(x, ln_w, ln_b, w1, b1, w2, b2, eps)  # no graph to record


# --------------------------------------------------------------------------
# Kernel B and B'
# --------------------------------------------------------------------------


def window_grid(h: int, w: int, window: int):
    """(windows along h, windows along w) of the zero-padded grid."""
    return -(-h // window), -(-w // window)


def window_partition(z: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (N, S, C): zero-pad to the window multiple and
    partition (window == 0: one row set per image)."""
    bsz, hh, ww, c = z.shape
    if not window:
        return z.reshape(bsz, hh * ww, c)
    nwy, nwx = window_grid(hh, ww, window)
    z = F.pad(z, (0, 0, 0, nwx * window - ww, 0, nwy * window - hh))
    return (
        z.reshape(bsz, nwy, window, nwx, window, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(bsz * nwy * nwx, window * window, c)
    )


def window_unpartition(y: torch.Tensor, grid: Tuple[int, int, int], window: int):
    """Inverse of :func:`window_partition`, cropping the pad: (N, S, C) -> (B, H, W, C)."""
    bsz, hh, ww = grid
    c = y.shape[-1]
    if not window:
        return y.reshape(bsz, hh, ww, c)
    nwy, nwx = window_grid(hh, ww, window)
    return (
        y.reshape(bsz, nwy, nwx, window, window, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(bsz, nwy * window, nwx * window, c)[:, :hh, :ww]
    )


def ln_qkv_headmajor_plain(
    x: torch.Tensor,
    ln_w: Optional[torch.Tensor],
    ln_b: Optional[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
    heads3: int,
    window: int = 0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """x (B, H, W, C) -> head-major qkv (N, heads3, S, d).

    window == 0: N = B, S = H*W. window > 0: the grid is zero-padded AFTER
    the LayerNorm to a multiple of ``window`` and partitioned, N = B*nW,
    S = window^2 (windows in row-major order)."""
    dt = x.dtype
    z = layer_norm(x, ln_w, ln_b, eps) if ln_w is not None else x
    y = (window_partition(z, window) @ w.to(dt).t()) + b.to(dt)
    n, s, o = y.shape
    return y.reshape(n, s, heads3, o // heads3).permute(0, 2, 1, 3).contiguous()


def ln_rows_plain(x, ln_w, ln_b, window: int = 0, eps: float = 1e-6) -> torch.Tensor:
    """Kernel B's row pass: x (B, H, W, C) -> z (N*S, C), LN (when ``ln_w``
    is given) then the zero-padded window partition, in x's dtype."""
    z = layer_norm(x, ln_w, ln_b, eps) if ln_w is not None else x
    return window_partition(z, window).reshape(-1, x.shape[-1])


def ln_qkv_headmajor_bwd_plain(x, ln_w, ln_b, w, b, dy, heads3: int,
                               window: int = 0, eps: float = 1e-6):
    """Backward of :func:`ln_qkv_headmajor_plain`, as the JAX kernel bodies
    ``_ln_qkv_bwd_kernel`` / ``_strip_qkv_bwd_kernel`` compute it (fp32
    products of the dtype's values, dx cast to x's dtype). Window pad rows
    carry z = 0 and feed no token, but their dy adds to db. Returns (dx,
    dln_w, dln_b, dw, db); the LN grads are None without LN."""
    bsz, hh, ww, c = x.shape
    dt = x.dtype
    if ln_w is not None:
        xhat, rstd = _ln_stats(x.float(), eps)
        z = (xhat * ln_w.float() + ln_b.float()).to(dt)
    else:
        z = x
    zr = window_partition(z, window)  # (N, S, C)
    n, s, _ = zr.shape
    k = heads3 * dy.shape[-1]
    dyf = dy.to(dt).float().permute(0, 2, 1, 3).reshape(n * s, k)
    dw = dyf.t() @ zr.float().reshape(n * s, c)  # (K, C)
    db = dyf.sum(dim=0)
    dz = window_unpartition((dyf @ w.to(dt).float()).reshape(n, s, c), (bsz, hh, ww), window)
    if ln_w is None:
        return dz.to(dt), None, None, dw.to(w.dtype), db.to(b.dtype)
    dx, dsc, dbi = _ln_bwd(
        dz.reshape(-1, c), ln_w.float(), xhat.reshape(-1, c), rstd.reshape(-1, 1)
    )
    return (dx.reshape(x.shape).to(dt), dsc.to(ln_w.dtype), dbi.to(ln_b.dtype),
            dw.to(w.dtype), db.to(b.dtype))


def _qkv_rows(x, heads3: int, window: int):
    bsz, hh, ww, _ = x.shape
    if window:
        nwy, nwx = window_grid(hh, ww, window)
        return bsz * nwy * nwx, window * window
    return bsz, hh * ww


def _check_qkv_args(x, ln_w, ln_b, w, b, heads3):
    bsz, hh, ww, c = x.shape
    bf = torch.bfloat16
    check_cuda_tensor("x", x, bf, (bsz, hh, ww, c))
    check_cuda_tensor("w", w, bf, (heads3 * 64, c))
    check_cuda_tensor("b", b, bf, (heads3 * 64,))
    if ln_w is not None:
        check_cuda_tensor("ln_w", ln_w, torch.float32, (c,))
        check_cuda_tensor("ln_b", ln_b, torch.float32, (c,))
    if c % 64 or c > 2048:
        raise ValueError(f"ln_qkv_headmajor: C={c} is not a multiple of 64 up to 2048")


def _ln_qkv_headmajor_fwd(x, ln_w, ln_b, w, b, heads3, window, eps):
    if x.device.type == "cpu":
        return ln_qkv_headmajor_plain(x, ln_w, ln_b, w, b, heads3, window, eps)
    _check_qkv_args(x, ln_w, ln_b, w, b, heads3)
    bsz, hh, ww, c = x.shape
    n, s = _qkv_rows(x, heads3, window)
    variant = "window" if window else "global"
    z = torch.empty((n * s, c), dtype=torch.bfloat16, device=x.device)
    LN_ROWS.launch(
        ptr(x), ptr(ln_w) if ln_w is not None else _NULL,
        ptr(ln_b) if ln_b is not None else _NULL, ptr(z), bsz, hh, ww, c, window, eps,
        variant=variant,
    )
    out = torch.empty((n, heads3, s, 64), dtype=torch.bfloat16, device=x.device)
    LN_QKV_HEADMAJOR.launch(ptr(z), ptr(w), ptr(b), ptr(out), n, s, c, heads3,
                            variant=variant)
    return out


def ln_qkv_headmajor_bwd(x, ln_w, ln_b, w, b, dy, heads3: int, window: int = 0,
                         eps: float = 1e-6):
    """Kernel B' on CUDA tensors (the plain backward on the CPU): the
    gradients of :func:`ln_qkv_headmajor` given dy (N, heads3, S, 64)."""
    if x.device.type == "cpu":
        return ln_qkv_headmajor_bwd_plain(x, ln_w, ln_b, w, b, dy, heads3, window, eps)
    _check_qkv_args(x, ln_w, ln_b, w, b, heads3)
    bsz, hh, ww, c = x.shape
    n, s = _qkv_rows(x, heads3, window)
    if c % 256 or c > 1280:  # the row kernels' widths, up to ViT-H
        raise ValueError(f"ln_qkv_headmajor_bwd: C={c} is not a multiple of 256 up to 1280")
    check_cuda_tensor("dy", dy, torch.bfloat16, (n, heads3, s, 64))
    t, k = bsz * hh * ww, heads3 * 64
    f32, bf = torch.float32, torch.bfloat16
    # db's partials (every output row, pad rows too), then dgamma / dbeta's
    parts = -(-(n * s) // _DY_PART_ROWS) * k + -(-t // _LN_PART_ROWS) * 2 * c
    dx, dg, dbb, dw, db, dyt, z, stats, dz, part = _bwd_scratch(
        x.device, (x.shape, bf), ((c,), f32), ((c,), f32), ((k, c), bf), ((k,), bf),
        ((t, k), bf), ((t, c), bf), ((2, t), f32), ((t, c), f32), ((parts,), f32),
    )
    with_ln = ln_w is not None
    LN_QKV_HEADMAJOR_BWD.launch(
        ptr(x), ptr(ln_w) if with_ln else _NULL, ptr(ln_b) if with_ln else _NULL,
        ptr(w), ptr(dy), ptr(dx), ptr(dg), ptr(dbb), ptr(dw), ptr(db), ptr(dyt), ptr(z),
        ptr(stats), ptr(dz), ptr(part), bsz, hh, ww, c, heads3, window,
        eps, variant="window" if window else "global",
    )
    if not with_ln:
        dg = dbb = None
    return dx, dg, dbb, dw, db


class _LnQkvHeadmajor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, b, heads3, window, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w, b)
        ctx.args = (heads3, window, eps)
        return _ln_qkv_headmajor_fwd(x, ln_w, ln_b, w, b, heads3, window, eps)

    @staticmethod
    def backward(ctx, dy):
        x, ln_w, ln_b, w, b = ctx.saved_tensors
        grads = ln_qkv_headmajor_bwd(x, ln_w, ln_b, w, b, dy.contiguous(), *ctx.args)
        return (*grads, None, None, None)


def ln_qkv_headmajor(x, ln_w, ln_b, w, b, heads3: int, window: int = 0,
                     eps: float = 1e-6):
    """Kernel B on CUDA tensors (bf16 x and weights, fp32 LN params), with
    B' as its backward; the plain versions on the CPU."""
    return _LnQkvHeadmajor.apply(x, ln_w, ln_b, w, b, heads3, window, eps)


# --------------------------------------------------------------------------
# Kernel K12' (kernel B without its LayerNorm)
# --------------------------------------------------------------------------


def qkv_headmajor_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        heads3: int, n: int) -> torch.Tensor:
    """x (N*S, C) flat tokens -> head-major x W^T + b (N, heads3, S, d), the
    product cast to x's dtype before the bias add (JAX ``_qkv_pair_kernel``)."""
    dt = x.dtype
    y = (x @ w.to(dt).t()) + b.to(dt)
    return y.reshape(n, -1, heads3, y.shape[-1] // heads3).permute(0, 2, 1, 3).contiguous()


def _qkv_headmajor_fwd(x, w, b, heads3, n):
    if x.device.type == "cpu":
        return qkv_headmajor_plain(x, w, b, heads3, n)
    t, c = x.shape
    bf = torch.bfloat16
    check_cuda_tensor("x", x, bf, (t, c))
    check_cuda_tensor("w", w, bf, (heads3 * 64, c))
    check_cuda_tensor("b", b, bf, (heads3 * 64,))
    if c % 64 or t % n:
        raise ValueError(f"qkv_headmajor: C={c} not a multiple of 64 or {t} rows for N={n}")
    out = torch.empty((n, heads3, t // n, 64), dtype=bf, device=x.device)
    QKV_HEADMAJOR.launch(ptr(x), ptr(w), ptr(b), ptr(out), n, t // n, c, heads3,
                         variant="window" if t // n <= 512 else "global")
    return out


def qkv_headmajor_bwd(x, w, dy):
    """Backward of :func:`qkv_headmajor` given dy (N, heads3, S, d), as JAX's
    ``_qkv_pair_bwd_vjp`` takes it (``jax.vjp`` of ``x @ w + b``, left to
    XLA): plain torch products on every device. Returns (dx, dw, db): dx =
    dy W in x's dtype, dw = dy^T x, db = the column sums of dy."""
    dyf = dy.permute(0, 2, 1, 3).reshape(x.shape[0], w.shape[0]).to(x.dtype)
    return dyf @ w.to(x.dtype), (dyf.t() @ x).to(w.dtype), dyf.sum(dim=0)


class _QkvHeadmajor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, heads3, n):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return _qkv_headmajor_fwd(x, w, b, heads3, n)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = qkv_headmajor_bwd(x, w, dy)
        return dx, dw, db.to(ctx.b_dtype), None, None


def qkv_headmajor(x, w, b, heads3: int, n: int):
    """Kernel K12' on CUDA tensors (bf16 x (N*S, C), w (heads3*64, C), b);
    the plain version on the CPU. Returns (N, heads3, S, 64). Its backward
    is :func:`qkv_headmajor_bwd` on every device."""
    return _QkvHeadmajor.apply(x, w, b, heads3, n)
