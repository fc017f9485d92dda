"""Plain versions of the port's kernels A, B, C held against the JAX kernels.

On the CPU the port's wrappers run the plain torch versions (the CUDA kernels
themselves are checked against those on the card by ``chip_smoke.py``); the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. Inputs are seeded numpy arrays; fp32 on both sides, tolerance 2e-4.
JAX packs two heads per 128 lanes; the tests unpack those pairs in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.ops.attention import attention_rel_pos as jax_attention_rel_pos
from rsprompter_tpu.ops.fused_mlp import (
    fused_ln_qkv,
    fused_mlp_residual,
    fused_qkv_window_pair,
)
from rsprompter_tpu.ops.fused_vit_attention import fused_qkv_attention_pair
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa
from rsprompter_tpu_torch.ops.attention import attention_rel_pos, rel_pos_factors

TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _unpack_pairs(x):
    """(B, m, S, 2d) lane pairs -> (B, 2m, S, d), numpy."""
    x = np.asarray(x)
    b, m, s, d2 = x.shape
    return x.reshape(b, m, s, 2, d2 // 2).transpose(0, 1, 3, 2, 4).reshape(b, 2 * m, s, d2 // 2)


def _pack_pairs(x):
    b, n, s, d = x.shape
    return x.reshape(b, n // 2, 2, s, d).transpose(0, 1, 3, 2, 4).reshape(b, n // 2, s, 2 * d)


def _ln_params(rng, c):
    return (1 + 0.1 * rng.standard_normal(c)).astype(np.float32), (
        0.1 * rng.standard_normal(c)
    ).astype(np.float32)


def test_ln_mlp_residual_plain_matches_pallas():
    """T = 2048 so ``fused_mlp_residual`` takes its Pallas body (interpreted)."""
    rng = np.random.default_rng(0)
    t, c, m = 2048, 128, 512
    x = rng.standard_normal((t, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    w1 = (rng.standard_normal((c, m)) * 0.05).astype(np.float32)  # JAX (in, out)
    b1 = (rng.standard_normal(m) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((m, c)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.05).astype(np.float32)
    ref = fused_mlp_residual(*(jnp.asarray(a) for a in (x, g, b, w1, b1, w2, b2)), 1e-6)
    got = fm.ln_mlp_residual(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_ln_qkv_headmajor_plain_matches_pallas_global():
    """``fused_ln_qkv`` (interpreted Pallas): LN + qkv, pair-packed heads."""
    rng = np.random.default_rng(1)
    bsz, h, w, c, heads = 2, 16, 16, 128, 2
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    wq = (rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32)
    bq = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    ref = fused_ln_qkv(
        jnp.asarray(x.reshape(-1, c)), jnp.asarray(g), jnp.asarray(b), jnp.asarray(wq),
        jnp.asarray(bq), 1e-6, 3 * heads, bsz,
    )
    got = fm.ln_qkv_headmajor(_t(x), _t(g), _t(b), _t(wq.T), _t(bq), 3 * heads, 0, 1e-6)
    np.testing.assert_allclose(got.numpy(), _unpack_pairs(ref), atol=TOL, rtol=TOL)


def test_ln_qkv_headmajor_plain_matches_window_pair():
    """JAX normalises, zero-pads the grid to the window multiple, then runs
    ``fused_qkv_window_pair``; the port does LN + pad + partition in one
    call. Pad positions carry the bias alone."""
    rng = np.random.default_rng(2)
    bsz, h, w, c, heads, win = 2, 10, 10, 128, 2, 4
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    wq = (rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32)
    bq = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    z = (x - mu) / np.sqrt(var + 1e-6) * g + b
    zp = np.pad(z, ((0, 0), (0, 2), (0, 2), (0, 0)))
    ref = fused_qkv_window_pair(jnp.asarray(zp), jnp.asarray(wq), jnp.asarray(bq), 3 * heads, win)
    got = fm.ln_qkv_headmajor(_t(x), _t(g), _t(b), _t(wq.T), _t(bq), 3 * heads, win, 1e-6)
    assert got.shape == (bsz * 9, 3 * heads, win * win, 64)
    np.testing.assert_allclose(got.numpy(), _unpack_pairs(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hw", [(7, 7), (32, 32)], ids=["window-kernel", "global-kernel"])
def test_relpos_attention_plain_matches_pallas_safe(hw):
    """``fused_qkv_attention_pair(safe=True)``: the exact-softmax Pallas
    kernels (window kernel for S <= 512, full global kernel above),
    interpreted; the port's factors come from its torch einsum."""
    rng = np.random.default_rng(3)
    h, w = hw
    bsz, heads, s = 1, 2, h * w
    qkv = rng.standard_normal((bsz, 3 * heads, s, 64)).astype(np.float32)
    th = (rng.standard_normal((2 * h - 1, 64)) * 0.5).astype(np.float32)
    tw = (rng.standard_normal((2 * w - 1, 64)) * 0.5).astype(np.float32)
    ref = fused_qkv_attention_pair(
        jnp.asarray(_pack_pairs(qkv)), jnp.asarray(th), jnp.asarray(tw), hw, True
    )
    q = _t(qkv)[:, :heads]
    fh, fw = rel_pos_factors(q, _t(th), _t(tw), hw)
    got = fa.relpos_attention(_t(qkv), fh, fw, hw)
    np.testing.assert_allclose(got.numpy(), _unpack_pairs(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tables", ["native", "resized"])
def test_attention_rel_pos_matches_jax(tables):
    """The plain oracle against ``rsprompter_tpu.ops.attention`` (XLA path),
    with tables of the grid's length or resized from another length."""
    rng = np.random.default_rng(4)
    h, w = 6, 5
    q, k, v = (rng.standard_normal((2, 3, h * w, 16)).astype(np.float32) for _ in range(3))
    lh, lw = (2 * h - 1, 2 * w - 1) if tables == "native" else (15, 7)
    th = rng.standard_normal((lh, 16)).astype(np.float32)
    tw = rng.standard_normal((lw, 16)).astype(np.float32)
    ref = jax_attention_rel_pos(*(jnp.asarray(a) for a in (q, k, v)), (h, w),
                                jnp.asarray(th), jnp.asarray(tw))
    got = attention_rel_pos(_t(q), _t(k), _t(v), (h, w), _t(th), _t(tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    qkv = torch.cat([_t(q), _t(k), _t(v)], dim=1)
    fh, fw = rel_pos_factors(_t(q), _t(th), _t(tw), (h, w))
    np.testing.assert_allclose(
        fa.relpos_attention(qkv, fh, fw, (h, w)).numpy(), np.asarray(ref), atol=TOL, rtol=TOL
    )


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA-side check runs before any launch: wrong dtype raises (here
    on a meta tensor, so no card is needed): default-fp32 activations with
    bf16 weights are a mix no kernel variant takes."""
    x = torch.empty((8, 768), device="meta")
    w1 = torch.empty((3072, 768), device="meta", dtype=torch.bfloat16)
    w2 = torch.empty((768, 3072), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        fm.ln_mlp_residual(x, x[0], x[0], w1, w1[:, 0], w2, w2[:, 0])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def _wrapper_call(kind, act, wt):
    """(wrapper, args) of a forward kernel at ViT-B's widths on meta tensors:
    activations in ``act``, weights, biases and factors in ``wt``."""
    c, heads = 768, 12
    if kind == "A":
        return fm.ln_mlp_residual, (_meta(8, c, dtype=act), _meta(c), _meta(c),
                                    _meta(4 * c, c, dtype=wt), _meta(4 * c, dtype=wt),
                                    _meta(c, 4 * c, dtype=wt), _meta(c, dtype=wt))
    if kind == "B":
        return fm.ln_qkv_headmajor, (_meta(1, 4, 4, c, dtype=act), _meta(c), _meta(c),
                                     _meta(3 * c, c, dtype=wt), _meta(3 * c, dtype=wt),
                                     3 * heads, 0)
    if kind == "K12'":
        return fm.qkv_headmajor, (_meta(16, c, dtype=act), _meta(3 * c, c, dtype=wt),
                                  _meta(3 * c, dtype=wt), 3 * heads, 1)
    return fa.relpos_attention, (_meta(1, 3 * heads, 16, 64, dtype=act),
                                 _meta(1, heads, 16, 4, dtype=wt),
                                 _meta(1, heads, 16, 4, dtype=wt), (4, 4))


@pytest.mark.parametrize("act,wt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16),
], ids=["fp32", "bf16", "fp32-x-bf16-w", "bf16-x-fp32-w", "fp16"])
@pytest.mark.parametrize("kind", ["A", "B", "K12'", "C"])
def test_wrappers_take_one_dtype_and_refuse_a_mix(kind, act, wt, monkeypatch):
    """Kernels A, B, K12' and C take x and their weights (C: qkv and the
    factors) all bf16 or all fp32 (the 3xTF32 variant). On meta tensors a
    consistent set passes the dtype check and stops at the device check; a
    mix, or another dtype, stops at the dtype check. Neither launches."""
    from rsprompter_tpu_torch.ops import _cuda

    def no_launch(self, *args, **kwargs):
        raise AssertionError(f"{self.name} launched")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", no_launch)
    fn, args = _wrapper_call(kind, act, wt)
    ok = act == wt and act in (torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="expected a CUDA tensor" if ok else "bf16 or fp32|one dtype"):
        with torch.no_grad():
            fn(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["A", "B", "K12'", "C"])
def test_wrappers_refuse_an_fp32_graph_before_any_launch(kind, dtype, monkeypatch):
    """Recording a graph, A, B and C refuse fp32 operands in the wrapper,
    before the forward launches (their backwards A', B', C' take bf16 only);
    K12''s backward is torch products, so it takes fp32 there. bf16, and
    K12' at fp32, pass on to the device check (meta tensors)."""
    from rsprompter_tpu_torch.ops import _cuda

    def no_launch(self, *args, **kwargs):
        raise AssertionError(f"{self.name} launched")

    monkeypatch.setattr(_cuda.CudaKernel, "launch", no_launch)
    fn, args = _wrapper_call(kind, dtype, dtype)
    args[0].requires_grad_(True)
    refused = dtype == torch.float32 and kind != "K12'"
    with pytest.raises(ValueError, match="backward kernel takes bf16" if refused
                       else "expected a CUDA tensor"):
        fn(*args)


def test_ln_qkv_headmajor_plain_matches_jax_hd80():
    """Head dim 80 (ViT-H), where JAX's LN + qkv kernels take 64 only and
    its encoder projects with XLA: kernel B's plain version against
    ``jnp`` LN, the zero-padded window partition and the projection, held
    head-major, fp32."""
    rng = np.random.default_rng(5)
    bsz, h, w, heads, d, win = 2, 5, 6, 2, 80, 4
    c = heads * d
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    wq = (rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32)
    bq = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    xj = jnp.asarray(x)
    mu = xj.mean(-1, keepdims=True)
    z = (xj - mu) / jnp.sqrt(((xj - mu) ** 2).mean(-1, keepdims=True) + 1e-6) * g + b
    z = jnp.pad(z, ((0, 0), (0, 8 - h), (0, 8 - w), (0, 0)))
    z = z.reshape(bsz, 2, win, 2, win, c).transpose(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
    ref = (z @ wq + bq).reshape(-1, win * win, 3 * heads, d).transpose(0, 2, 1, 3)
    got = fm.ln_qkv_headmajor(_t(x), _t(g), _t(b), _t(wq.T), _t(bq), 3 * heads, win, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_relpos_attention_plain_matches_jax_hd80():
    """Head dim 80: kernel C's plain version (factors from the port's
    einsum) against ``rsprompter_tpu.ops.attention`` (XLA: JAX's route at
    head dim 80), on a ragged 6 x 5 grid, fp32."""
    rng = np.random.default_rng(6)
    h, w, d = 6, 5, 80
    q, k, v = (rng.standard_normal((2, 2, h * w, d)).astype(np.float32) for _ in range(3))
    th = (rng.standard_normal((2 * h - 1, d)) * 0.3).astype(np.float32)
    tw = (rng.standard_normal((2 * w - 1, d)) * 0.3).astype(np.float32)
    ref = jax_attention_rel_pos(*(jnp.asarray(a) for a in (q, k, v)), (h, w),
                                jnp.asarray(th), jnp.asarray(tw))
    fh, fw = rel_pos_factors(_t(q), _t(th), _t(tw), (h, w))
    got = fa.relpos_attention(torch.cat([_t(q), _t(k), _t(v)], dim=1), fh, fw, (h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
