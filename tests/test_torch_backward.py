"""Plain backwards of the port's kernels A', B', C' held against the JAX
Pallas backward kernels and against torch autograd.

The JAX side calls its Pallas backward bodies directly, interpreted on the
CPU (as ``tests/test_fused_ops.py`` does): ``_mlp_bwd_pallas``,
``_ln_qkv_bwd_pallas``, ``_qkv_window_bwd_pallas`` and ``_pair_bwd_pallas``;
JAX packs two heads per 128 lanes, which the tests undo in numpy. The port's
side is the plain backward each CUDA kernel is checked against on the card.
Seeded numpy inputs, fp32 on both sides; tolerance 2e-4 of each output's
largest magnitude (sums in another order). On the CPU the public wrappers
go through the same ``autograd.Function`` as on the card, with the plain
versions inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.ops.fused_mlp import (
    _ln as jax_ln,
    _ln_qkv_bwd_pallas,
    _mlp_bwd_pallas,
    _qkv_window_bwd_pallas,
)
from rsprompter_tpu.ops.fused_vit_attention import _pair_bwd_pallas
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa
from rsprompter_tpu_torch.ops.attention import rel_pos_factors
from test_torch_kernels import _pack_pairs, _unpack_pairs

TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref, name=""):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max(), err_msg=name)


def _ln_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def test_ln_mlp_residual_bwd_plain_matches_pallas():
    rng = np.random.default_rng(0)
    t, c, m = 256, 128, 512
    x = rng.standard_normal((t, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    w1 = (rng.standard_normal((c, m)) * 0.05).astype(np.float32)  # JAX (in, out)
    b1 = (rng.standard_normal(m) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((m, c)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.05).astype(np.float32)
    dout = rng.standard_normal((t, c)).astype(np.float32)
    ref = _mlp_bwd_pallas(*(jnp.asarray(a) for a in (x, g, b, w1, b1, w2, b2)), 1e-6,
                          jnp.asarray(dout))
    got = fm.ln_mlp_residual_bwd_plain(_t(x), _t(g), _t(b), _t(w1.T), _t(b1), _t(w2.T),
                                       _t(b2), _t(dout), 1e-6)
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    for name, r, o in zip(names, ref, got):
        o = o.numpy()
        _close(o.T if name in ("dw1", "dw2") else o, r, name)


@pytest.mark.parametrize("a_mn,b_mn,bn", fm.WGMMA_GEMM_FORMS)
def test_wgmma_gemm_layouts_plain(a_mn, b_mn, bn):
    """A''s GEMM mainloop surface on the CPU (its plain version): each
    operand read as stored, (rows, K) or, MN-major, (K, rows), gives A . B^T.
    The card tests hold the kernel to the same surface."""
    rng = np.random.default_rng(3)
    rows, cols, k = 40, 24, 56
    a = rng.standard_normal((rows, k)).astype(np.float32)
    b = rng.standard_normal((cols, k)).astype(np.float32)
    got = fm.wgmma_gemm_f32(_t(a.T if a_mn else a), _t(b.T if b_mn else b), a_mn, b_mn, bn)
    _close(got.numpy(), a @ b.T)


def test_ln_qkv_headmajor_bwd_plain_matches_pallas_global():
    rng = np.random.default_rng(1)
    bsz, h, w, c, heads = 2, 16, 16, 128, 2
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    wq = (rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32)
    bq = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    dy = rng.standard_normal((bsz, 3 * heads, h * w, 64)).astype(np.float32)
    ref = _ln_qkv_bwd_pallas(
        jnp.asarray(x.reshape(-1, c)), jnp.asarray(g), jnp.asarray(b), jnp.asarray(wq),
        jnp.asarray(bq), 1e-6, 3 * heads, bsz, jnp.asarray(_pack_pairs(dy)),
    )
    got = fm.ln_qkv_headmajor_bwd_plain(_t(x), _t(g), _t(b), _t(wq.T), _t(bq), _t(dy),
                                        3 * heads, 0, 1e-6)
    _close(got[0].numpy().reshape(-1, c), ref[0], "dx")
    _close(got[1].numpy(), ref[1], "dln_w")
    _close(got[2].numpy(), ref[2], "dln_b")
    _close(got[3].numpy().T, ref[3], "dw")
    _close(got[4].numpy(), ref[4], "db")


def test_ln_qkv_headmajor_bwd_plain_matches_window_pallas():
    """JAX normalises, zero-pads the 10x10 grid to 12x12, then runs the strip
    kernel; its backward (``_qkv_window_bwd_pallas``) composed with the vjp
    of LN + pad is the port's fused window backward. Every pad row carries a
    non-zero dy, which reaches db and nothing else."""
    rng = np.random.default_rng(2)
    bsz, h, w, c, heads, win = 2, 10, 10, 128, 2, 4
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32)
    g, b = _ln_params(rng, c)
    wq = (rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32)
    bq = (rng.standard_normal(3 * c) * 0.05).astype(np.float32)
    dy = rng.standard_normal((bsz * 9, 3 * heads, win * win, 64)).astype(np.float32)

    def ln_pad(x_, g_, b_):
        return jnp.pad(jax_ln(x_, g_, b_, 1e-6), ((0, 0), (0, 2), (0, 2), (0, 0)))

    zp, vjp = jax.vjp(ln_pad, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    dzp, dw, db = _qkv_window_bwd_pallas(zp, jnp.asarray(wq), jnp.asarray(bq), 3 * heads,
                                         win, jnp.asarray(_pack_pairs(dy)))
    dx, dg, dbb = vjp(dzp)
    got = fm.ln_qkv_headmajor_bwd_plain(_t(x), _t(g), _t(b), _t(wq.T), _t(bq), _t(dy),
                                        3 * heads, win, 1e-6)
    for name, o, r in zip(("dx", "dln_w", "dln_b"), got[:3], (dx, dg, dbb)):
        _close(o.numpy(), r, name)
    _close(got[3].numpy().T, dw, "dw")
    _close(got[4].numpy(), db, "db")
    # the pad rows' dy is part of db: without it db would be off
    real = np.zeros((bsz, 3, 3, win, win), bool)
    real[:, :, :, :, :] = True
    real[:, 2, :, 2:, :] = False  # bottom window row: grid rows 10, 11 are pad
    real[:, :, 2, :, 2:] = False  # right window column: grid cols 10, 11 are pad
    dy_rows = dy.transpose(0, 2, 1, 3).reshape(bsz * 9 * win * win, -1)
    db_real_only = dy_rows[real.reshape(-1)].sum(0)
    assert np.abs(db_real_only - got[4].numpy()).max() > 100 * TOL * np.abs(db).max()


@pytest.mark.parametrize("hw", [(7, 7), (32, 32)], ids=["window-kernel", "global-kernel"])
def test_relpos_attention_bwd_plain_matches_pallas(hw):
    """``_pair_bwd_pallas`` returns the full backward, the factors' vjp
    included; the port's plain backward gives dqkv, dfh, dfw and torch
    autograd carries dfh, dfw on through ``rel_pos_factors``."""
    rng = np.random.default_rng(3)
    h, w = hw
    bsz, heads, s = 1, 2, h * w
    qkv = rng.standard_normal((bsz, 3 * heads, s, 64)).astype(np.float32)
    th = (rng.standard_normal((2 * h - 1, 64)) * 0.5).astype(np.float32)
    tw = (rng.standard_normal((2 * w - 1, 64)) * 0.5).astype(np.float32)
    dout = rng.standard_normal((bsz, heads, s, 64)).astype(np.float32)
    dqkv_p, dth, dtw = _pair_bwd_pallas(
        jnp.asarray(_pack_pairs(qkv)), jnp.asarray(th), jnp.asarray(tw),
        jnp.asarray(_pack_pairs(dout)), hw,
    )
    qkv_t, th_t, tw_t = (_t(a).requires_grad_(True) for a in (qkv, th, tw))
    fh, fw = rel_pos_factors(qkv_t[:, :heads], th_t, tw_t, hw)
    dqkv, dfh, dfw = fa.relpos_attention_bwd_plain(
        qkv_t.detach(), fh.detach(), fw.detach(), _t(dout), hw)
    dq_bias, dth_t, dtw_t = torch.autograd.grad([fh, fw], [qkv_t, th_t, tw_t], [dfh, dfw])
    _close((dqkv + dq_bias).numpy(), _unpack_pairs(dqkv_p), "dqkv")
    _close(dth_t.numpy(), dth, "d rel_pos_h")
    _close(dtw_t.numpy(), dtw, "d rel_pos_w")


def _autograd(fn, inputs, dout):
    leaves = [a.clone().requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("window", [0, 3])
def test_plain_backwards_match_autograd(window):
    """Each plain backward against torch autograd of its plain forward
    (ragged: 50 rows; a 7x8 grid that pads to 9x9 under window 3; S = 35)."""
    rng = np.random.default_rng(4)
    c, m = 64, 128
    x = _t(rng.standard_normal((50, c)))
    lw, lb = (_t(a) for a in _ln_params(rng, c))
    w1, b1 = _t(rng.standard_normal((m, c)) * 0.1), _t(rng.standard_normal(m) * 0.1)
    w2, b2 = _t(rng.standard_normal((c, m)) * 0.1), _t(rng.standard_normal(c) * 0.1)
    args = (x, lw, lb, w1, b1, w2, b2)
    dout = _t(rng.standard_normal((50, c)))
    ref = _autograd(lambda *a: fm.ln_mlp_residual_plain(*a, 1e-6), args, dout)
    for r, o in zip(ref, fm.ln_mlp_residual_bwd_plain(*args, dout, 1e-6)):
        _close(o, r)

    xg = _t(rng.standard_normal((2, 7, 8, c)))
    wq, bq = _t(rng.standard_normal((3 * c, c)) * 0.1), _t(rng.standard_normal(3 * c) * 0.1)
    dy = torch.randn_like(fm.ln_qkv_headmajor_plain(xg, lw, lb, wq, bq, 3, window))
    ref = _autograd(lambda *a: fm.ln_qkv_headmajor_plain(*a, 3, window), (xg, lw, lb, wq, bq),
                    dy)
    for r, o in zip(ref, fm.ln_qkv_headmajor_bwd_plain(xg, lw, lb, wq, bq, dy, 3, window)):
        _close(o, r)

    hw = (5, 7)
    qkv = _t(rng.standard_normal((2, 6, 35, 64)))
    fh, fw = _t(rng.standard_normal((2, 2, 35, 5))), _t(rng.standard_normal((2, 2, 35, 7)))
    da = _t(rng.standard_normal((2, 2, 35, 64)))
    ref = _autograd(lambda *a: fa.relpos_attention_plain(*a, hw), (qkv, fh, fw), da)
    for r, o in zip(ref, fa.relpos_attention_bwd_plain(qkv, fh, fw, da, hw)):
        _close(o, r)


def test_cpu_path_is_differentiable_through_the_function():
    """On the CPU the public wrappers are the same ``autograd.Function``s as
    on the card (plain forward and backward inside): outputs carry them, and
    the gradients are the plain backwards'."""
    rng = np.random.default_rng(5)
    c, m = 64, 128
    leaves = [_t(rng.standard_normal(s) * 0.1).requires_grad_(True)
              for s in ((20, c), (c,), (c,), (m, c), (m,), (c, m), (c,))]
    out = fm.ln_mlp_residual(*leaves)
    assert type(out.grad_fn).__name__ == "_LnMlpResidualBackward"
    dout = _t(rng.standard_normal((20, c)))
    grads = torch.autograd.grad(out, leaves, dout)
    for g, r in zip(grads, fm.ln_mlp_residual_bwd_plain(*[a.detach() for a in leaves], dout)):
        _close(g, r)
    xg = _t(rng.standard_normal((1, 6, 6, c))).requires_grad_(True)
    assert type(fm.ln_qkv_headmajor(xg, None, None, leaves[3].repeat(3, 1)[:3 * c],
                                    torch.zeros(3 * c), 3, 4).grad_fn).__name__ == \
        "_LnQkvHeadmajorBackward"
    qkv = _t(rng.standard_normal((1, 3, 16, 64))).requires_grad_(True)
    fh = _t(rng.standard_normal((1, 1, 16, 4)))
    out = fa.relpos_attention(qkv, fh, fh, (4, 4))
    assert type(out.grad_fn).__name__ == "_RelposAttentionBackward"
