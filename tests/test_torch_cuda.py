"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these build the kernels with nvcc and launch them, so they
skip where ``torch.cuda.is_available()`` is false. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes are small and ragged (row counts and grids that are not multiples of
the kernels' tiles) to reach the edge paths the main-path shapes do not;
``chip_smoke.py`` covers the main-path shapes. bf16 inputs, fp32 plain
reference, tolerance 2e-2 of the output's largest magnitude; the fp32
variants (3xTF32) against the plain fp32 versions with TF32 off, tolerance
1e-4 (``F32_TOL``), and repeatable bit for bit.
"""

import pytest
import torch

from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.Generator().manual_seed(0)


def _rnd(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)


def _close(got, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL * ref.float().abs().max().item(), err


def _f32(args):
    return [a.float() if torch.is_tensor(a) else a for a in args]


def _mlp_args(gen, t, c=768):
    m = 4 * c
    return (
        _rnd(gen, t, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
        _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, m, c, scale=0.02),
        _rnd(gen, m, scale=0.02), _rnd(gen, c, m, scale=0.02), _rnd(gen, c, scale=0.02),
        1e-6,
    )


@pytest.mark.parametrize("t", [100, 4096, 8193])
def test_ln_mlp_residual_kernel(gen, t):
    """Kernel A (row pass, fc1 + GELU, fc2 + residual) at row counts that
    are and are not multiples of the GEMMs' 128-row tile."""
    args = _mlp_args(gen, t)
    _close(fm.ln_mlp_residual(*args), fm.ln_mlp_residual_plain(*_f32(args)))


def _window_inputs(gen, n_img, heads, hw):
    s = hw[0] * hw[1]
    return (_rnd(gen, n_img, 3 * heads, s, 64), _rnd(gen, n_img, heads, s, hw[0], scale=0.5),
            _rnd(gen, n_img, heads, s, hw[1], scale=0.5), hw)


@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (16, 16), (1, 1)])
@pytest.mark.parametrize("heads", [1, 3, 5, 12])
def test_relpos_attention_window_path(gen, heads, hw):
    """Kernel C at window-sized grids: (14, 14), (9, 7) and (1, 1) take the
    window path (S <= 200: one key tile of 200 or 64 per (window, head),
    units walked by a persistent grid), (16, 16) the global path. The
    output and the row log-sum-exp the backward reads, against plain, at
    head counts that leave the last SMs' units uneven and at ragged grids
    whose factor rows are not 16-byte aligned."""
    qkv, fh, fw, _ = _window_inputs(gen, 5, heads, hw)
    out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
    qf = qkv.float()
    scores = fa._biased_scores(qf[:, :heads], qf[:, heads : 2 * heads], fh, fw)
    _close(out, fa.relpos_attention_plain(qf, fh.float(), fw.float(), hw))
    err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
    assert err <= 1e-3 * scores.abs().max().item(), err


@pytest.mark.parametrize("kernel", ["ln_mlp_residual", "relpos_attention"])
def test_forward_kernels_are_deterministic(gen, kernel):
    """Kernel A and kernel C's window path give the same bits twice: no
    sum depends on the order blocks run in."""
    if kernel == "ln_mlp_residual":
        args = _mlp_args(gen, 4096)
        run = lambda: fm.ln_mlp_residual(*args)  # noqa: E731
    else:
        args = _window_inputs(gen, 50, 12, (14, 14))
        run = lambda: fa._relpos_attention_fwd(*args, True)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first if isinstance(first, tuple) else (first,),
                    second if isinstance(second, tuple) else (second,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("grid,window", [((10, 9), 0), ((10, 9), 4), ((64, 64), 14)])
def test_ln_qkv_headmajor_kernel(gen, grid, window):
    c, heads = 768, 12
    args = (
        _rnd(gen, 2, *grid, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
        _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, 3 * c, c, scale=0.02),
        _rnd(gen, 3 * c, scale=0.02), 3 * heads, window, 1e-6,
    )
    _close(fm.ln_qkv_headmajor(*args), fm.ln_qkv_headmajor_plain(*_f32(args)))


@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (32, 32)])
def test_relpos_attention_kernel(gen, hw):
    n_img, heads, s = 3, 4, hw[0] * hw[1]
    qkv = _rnd(gen, n_img, 3 * heads, s, 64)
    fh = _rnd(gen, n_img, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, n_img, heads, s, hw[1], scale=0.5)
    _close(
        fa.relpos_attention(qkv, fh, fw, hw),
        fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw),
    )


def _close_each(got, ref):
    """Each output within TOL of its own largest magnitude."""
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None
            continue
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL * b.float().abs().max().item(), (i, err)


@pytest.mark.parametrize("n,s", [(1, 37), (3, 100), (5, 196)])
def test_qkv_headmajor_kernel(gen, n, s):
    """K12' at small, ragged row counts (N*S not a multiple of 32)."""
    c, heads3 = 768, 36
    args = (_rnd(gen, n * s, c), _rnd(gen, heads3 * 64, c, scale=0.02),
            _rnd(gen, heads3 * 64, scale=0.02), heads3, n)
    _close(fm.qkv_headmajor(*args), fm.qkv_headmajor_plain(*_f32(args)))


def test_qkv_headmajor_backward_on_cuda(gen):
    """K12' backpropagates on the card: dx, dw, db through the Function against the plain forward's autograd."""
    x = _rnd(gen, 100, 768)
    w, b = _rnd(gen, 6 * 64, 768, scale=0.02), _rnd(gen, 6 * 64)
    dy = _rnd(gen, 2, 6, 50, 64)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    fm.qkv_headmajor(*leaves, 6, 2).backward(dy)
    ref = [t.float().requires_grad_(True) for t in (x, w, b)]
    fm.qkv_headmajor_plain(*ref, 6, 2).backward(dy.float())
    _close_each([t.grad for t in leaves], [t.grad for t in ref])


@pytest.mark.parametrize("n,s,r", [(1, 37, 16), (3, 100, 4), (5, 196, 64)])
def test_qkv_headmajor_lora_kernel(gen, n, s, r):
    """K12' with the LoRA adapter folded into its K (C + 64), forward and
    every gradient (x, W, b, la, lb) against the plain version's autograd."""
    c, heads3 = 768, 36
    args = (_rnd(gen, n * s, c), _rnd(gen, heads3 * 64, c, scale=0.02),
            _rnd(gen, heads3 * 64, scale=0.02), _rnd(gen, c, r, scale=1.0 / r),
            _rnd(gen, r, heads3 * 64, scale=0.02))
    leaves = [t.clone().requires_grad_(True) for t in args]
    got = fm.qkv_headmajor_lora(*leaves, 2.0, heads3, n)
    ref_leaves = [t.float().requires_grad_(True) for t in args]
    ref = fm.qkv_headmajor_lora_plain(*ref_leaves, 2.0, heads3, n)
    _close(got, ref)
    dy = _rnd(gen, *got.shape)
    got.backward(dy)
    ref.backward(dy.float())
    _close_each([t.grad for t in leaves], [t.grad for t in ref_leaves])


@pytest.mark.parametrize("c", [768, 1024, 1280])
def test_qkv_gemm_widths(gen, c):
    """Kernel B and K12' at ViT-B/L/H widths: 300 rows (not a multiple of the
    128-row tile) and 9 heads of 64 (576 columns: the second 256-wide tile
    holds one real head of four)."""
    heads3, grid = 9, (15, 20)
    w, b = _rnd(gen, heads3 * 64, c, scale=0.02), _rnd(gen, heads3 * 64, scale=0.02)
    ln = (1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
          _rnd(gen, c, scale=0.1, dtype=torch.float32))
    x = _rnd(gen, 1, *grid, c)
    args = (x, *ln, w, b, heads3, 0, 1e-6)
    _close(fm.ln_qkv_headmajor(*args), fm.ln_qkv_headmajor_plain(*_f32(args)))
    flat = (x.reshape(-1, c), w, b, heads3, 1)
    _close(fm.qkv_headmajor(*flat), fm.qkv_headmajor_plain(*_f32(flat)))


@pytest.mark.parametrize("grid,window,ln", [((10, 9), 4, True), ((64, 64), 14, True),
                                            ((10, 9), 4, False)])
def test_ln_rows_kernel(gen, grid, window, ln):
    """Kernel B's row pass alone: LN, window partition and zero pad."""
    c = 768
    x = _rnd(gen, 2, *grid, c)
    lw = 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    lb = _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    n, s = fm._qkv_rows(x, 3, window)
    z = torch.empty((n * s, c), dtype=torch.bfloat16, device="cuda")
    fm.LN_ROWS.launch(fm.ptr(x), fm.ptr(lw) if ln else fm._NULL, fm.ptr(lb) if ln else fm._NULL,
                      fm.ptr(z), 2, *grid, c, window, 1e-6)
    _close(z, fm.ln_rows_plain(*_f32((x, lw, lb)), window))


@pytest.mark.parametrize("hw", [(64, 64), (32, 32), (9, 7)])
def test_relpos_attention_lse(gen, hw):
    """The row log-sum-exp the backward reads, in natural-log units, against
    a plain logsumexp of the biased scores (S = 4096, 1024, 63)."""
    n_img, heads, s = 1, 2, hw[0] * hw[1]
    qkv = _rnd(gen, n_img, 3 * heads, s, 64)
    fh = _rnd(gen, n_img, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, n_img, heads, s, hw[1], scale=0.5)
    out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
    qf = qkv.float()
    scores = fa._biased_scores(qf[:, :heads], qf[:, heads : 2 * heads], fh, fw)
    _close(out, fa.relpos_attention_plain(qf, fh.float(), fw.float(), hw))
    torch.cuda.synchronize()
    err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
    assert err <= 1e-3 * scores.abs().max().item(), err


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _rnd(gen, 1, 4, 4, 96)  # C not a multiple of 64
    w, b = _rnd(gen, 3 * 64, 96), _rnd(gen, 3 * 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        fm.ln_qkv_headmajor(x, None, None, w, b, 3)
    with pytest.raises(ValueError, match="multiple of 64"):
        fm.qkv_headmajor(x.reshape(16, 96), w, b, 3, 1)
    x = _rnd(gen, 1, 4, 4, 192)  # B' takes C a multiple of 256
    w, b = _rnd(gen, 9 * 64, 192), _rnd(gen, 9 * 64)
    with pytest.raises(ValueError, match="multiple of 256"):
        fm.ln_qkv_headmajor_bwd(x, None, None, w, b, _rnd(gen, 1, 9, 16, 64), 9)
    hw = (65, 1)  # h > 64
    qkv = _rnd(gen, 1, 3, 65, 64)
    with pytest.raises(ValueError, match="exceeds 64x64"):
        fa.relpos_attention(qkv, _rnd(gen, 1, 1, 65, 65), _rnd(gen, 1, 1, 65, 1), hw)


@pytest.mark.parametrize("heads,hw", [(3, (14, 14)), (1, (9, 7)), (5, (8, 8))])
def test_relpos_attention_kernel_odd_heads(gen, heads, hw):
    """Kernel C at odd head counts, the per-head layout of K11."""
    n_img, s = 4, hw[0] * hw[1]
    qkv = _rnd(gen, n_img, 3 * heads, s, 64)
    fh = _rnd(gen, n_img, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, n_img, heads, s, hw[1], scale=0.5)
    _close(
        fa.relpos_attention(qkv, fh, fw, hw),
        fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw),
    )


@pytest.mark.parametrize("t", [100, 4096])
def test_ln_mlp_residual_bwd_kernel(gen, t):
    c, m = 768, 3072
    args = (
        _rnd(gen, t, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
        _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, m, c, scale=0.02),
        _rnd(gen, m, scale=0.02), _rnd(gen, c, m, scale=0.02), _rnd(gen, c, scale=0.02),
        _rnd(gen, t, c),
    )
    _close_each(fm.ln_mlp_residual_bwd(*args, 1e-6),
                fm.ln_mlp_residual_bwd_plain(*_f32(args), 1e-6))


@pytest.mark.parametrize("t", [100, 4096])
def test_ln_mlp_residual_bwd_is_deterministic(gen, t):
    """Two launches of A' on the same inputs give the same bits in all seven
    outputs: every sum runs in a fixed order, with no atomics and no split
    of K."""
    args = (*_mlp_args(gen, t)[:7], _rnd(gen, t, 768))
    first = fm.ln_mlp_residual_bwd(*args, 1e-6)
    second = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# A''s five products by operand layout: (a stored, b stored, a_mn, b_mn, bn)
# for t tokens, C = 768, M = 3072
_AP_PRODUCTS = {
    "h = z W1^T": (("t", 768), (3072, 768), False, False, 256),
    "dO W2": (("t", 768), (768, 3072), False, True, 256),
    "dz = dh W1": (("t", 3072), (3072, 768), False, True, 128),
    "dW2 = dO^T g": (("t", 768), ("t", 3072), True, True, 256),
    "dW1 = dh^T z": (("t", 3072), ("t", 768), True, True, 256),
}


@pytest.mark.parametrize("t", [100, 200, 4096])
@pytest.mark.parametrize("product", list(_AP_PRODUCTS))
def test_wgmma_gemm_operand_layouts(gen, product, t):
    """A''s mainloop alone on each operand layout it runs, K-major or
    MN-major (the transposed wgmma forms), at ragged token counts: against
    an fp32 reference product within 2e-2 of the output's largest value."""
    a_shape, b_shape, a_mn, b_mn, bn = _AP_PRODUCTS[product]
    a = _rnd(gen, *[t if d == "t" else d for d in a_shape])
    b = _rnd(gen, *[t if d == "t" else d for d in b_shape])
    _close(fm.wgmma_gemm_f32(a, b, a_mn, b_mn, bn), fm.wgmma_gemm_f32_plain(a, b, a_mn, b_mn))


def _qkv_bwd_args(gen, bsz, grid, c, heads, window, ln):
    """B''s inputs at heads of c / heads; dy is drawn for every output row,
    window pad rows too."""
    x = _rnd(gen, bsz, *grid, c)
    lw = 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    lb = _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    w, b = _rnd(gen, 3 * c, c, scale=0.05), _rnd(gen, 3 * c, scale=0.05)
    n, s = fm._qkv_rows(x, 3 * heads, window)
    return (x, lw, lb, w, b, _rnd(gen, n, 3 * heads, s, c // heads), 3 * heads, window)


@pytest.mark.parametrize("bsz,grid,c,heads,window,ln", [
    (2, (10, 9), 256, 4, 0, True), (2, (10, 9), 256, 4, 4, True),
    (2, (32, 32), 256, 4, 14, True), (2, (10, 9), 256, 4, 4, False),
    (4, (32, 32), 768, 12, 0, True), (4, (32, 32), 768, 12, 14, True),
    (1, (15, 20), 1024, 16, 14, True), (1, (15, 20), 1280, 20, 0, True),
    (2, (10, 9), 1280, 16, 0, True), (2, (10, 9), 1280, 16, 4, True),
    (4, (32, 32), 1280, 16, 14, True), (1, (15, 20), 1280, 16, 0, False),
])
def test_ln_qkv_headmajor_bwd_kernel(gen, bsz, grid, c, heads, window, ln):
    """Window grids that need padding, pad rows with a non-zero dy, no LN,
    the ViT-B train step's shapes (x (4, 32, 32, 768), 12 heads, global and
    window 14), ViT-L / ViT-H widths (C = 1024, 1280: the row kernels'
    other instances), and ViT-H's 16 heads of 80 (global, padded windows,
    the train step's 32 x 32 under window 14, no LN)."""
    args = _qkv_bwd_args(gen, bsz, grid, c, heads, window, ln)
    _close_each(fm.ln_qkv_headmajor_bwd(*args), fm.ln_qkv_headmajor_bwd_plain(*_f32(args)))


@pytest.mark.parametrize("window", [0, 14])
def test_ln_qkv_headmajor_bwd_is_deterministic(gen, window):
    """Two launches of B' on the same inputs give the same bits in all five
    outputs: every sum runs in a fixed order, with no atomics and no split
    of K."""
    args = _qkv_bwd_args(gen, 4, (32, 32), 768, 12, window, True)
    first = fm.ln_qkv_headmajor_bwd(*args)
    second = fm.ln_qkv_headmajor_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _bwd_inputs(gen, n_img, heads, hw, d=64):
    s = hw[0] * hw[1]
    qkv = _rnd(gen, n_img, 3 * heads, s, d)
    fh = _rnd(gen, n_img, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, n_img, heads, s, hw[1], scale=0.5)
    dout = _rnd(gen, n_img, heads, s, d)
    out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
    return qkv, fh, fw, out, lse, dout, hw


@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (5, 13), (32, 32), (64, 64)])
def test_relpos_attention_bwd_kernel(gen, hw):
    """S = 196, 63, 65, 1024, 4096: key tiles of 64 end ragged in the first
    three; (64, 64) is the 1024^2 global grid, whose h + w = 128 takes the
    wider factor tiles. The first three read the log-sum-exp of kernel C's
    window path, the last two that of its global path."""
    n_img, heads = (1, 2) if hw == (64, 64) else (3, 4)
    qkv, fh, fw, out, lse, dout, _ = a = _bwd_inputs(gen, n_img, heads, hw)
    _close_each(
        fa.relpos_attention_bwd(*a),
        fa.relpos_attention_bwd_plain(qkv.float(), fh.float(), fw.float(), dout.float(), hw),
    )


@pytest.mark.parametrize("hw", [(14, 14), (32, 32)])
def test_relpos_attention_bwd_is_deterministic(gen, hw):
    """Two launches on the same inputs give the same bits in dqkv, dfh and
    dfw: every sum is taken in a fixed order, with no atomics."""
    a = _bwd_inputs(gen, 3, 4, hw)
    first = fa.relpos_attention_bwd(*a)
    second = fa.relpos_attention_bwd(*a)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_wrappers_record_their_backward_on_cuda(gen):
    """On a CUDA tensor that requires grad, each wrapper's output carries
    its Function, whose backward launches the backward kernel."""
    hw = (14, 14)
    qkv = _rnd(gen, 2, 6, 196, 64).requires_grad_(True)
    fh = _rnd(gen, 2, 2, 196, 14, scale=0.5).requires_grad_(True)
    fw = _rnd(gen, 2, 2, 196, 14, scale=0.5).requires_grad_(True)
    out = fa.relpos_attention(qkv, fh, fw, hw)
    assert out.grad_fn is not None
    before = sum(fa.RELPOS_ATTENTION_BWD.variant_launches.values())
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert sum(fa.RELPOS_ATTENTION_BWD.variant_launches.values()) == before + 1
    assert qkv.grad is not None and fh.grad is not None and fw.grad is not None


F32_ENCODER_TOL = 1e-3  # chip_smoke.py's limit: max|fp32 kernels - plain| / max|plain|


def test_fp32_encoder_runs_the_fp32_kernels(gen, tf32_off):
    """An fp32 model's encoder (SAM-det's segmentor) on the kernel route,
    taking no gradient: its blocks launch the fp32 variants of kernels A, B
    and C (no bf16 variant, no cast) and return fp32, within
    ``F32_ENCODER_TOL`` of the plain fp32 encoder (the bf16 kernels read
    about 2.5e-2 there on an H100, under a 4e-2 gate). A 10 x 10 grid under window 4
    pads each windowed layer to 12 x 12."""
    from rsprompter_tpu_torch.apis.build import init_random_weights
    from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
    from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder

    cfg = SamVisionConfig(hidden_size=768, num_hidden_layers=2, num_attention_heads=12,
                          global_attn_indexes=(1,), image_size=160, window_size=4)
    enc = SamVisionEncoder(cfg)
    init_random_weights(enc, 0)
    enc.to("cuda").eval()
    x = torch.randn(2, 160, 160, 3, generator=gen).to("cuda")
    kernels = (fm.LN_MLP_RESIDUAL, fm.LN_QKV_HEADMAJOR, fa.RELPOS_ATTENTION)
    for k in kernels:
        k.reset_counts()
    with torch.no_grad():
        got = enc(x)
        launched = [dict(k.variant_launches) for k in kernels]
        enc.impl = "plain"
        ref = enc(x)
    f32 = [sum(n for v, n in c.items() if v.endswith("/f32")) for c in launched]
    assert f32 == [4, 2, 2], launched  # A: fc1 + fc2 a layer
    assert all(v.endswith("/f32") for c in launched for v in c), launched
    for a, b in zip((got[0],) + got[1], (ref[0],) + ref[1]):
        assert a.dtype == b.dtype == torch.float32
        assert torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= F32_ENCODER_TOL * b.abs().max().item(), err


def test_fp32_flash_encoder_runs_the_fp32_kernels(gen, tf32_off):
    """The 'flash' route of an fp32 encoder that takes no gradient: K12' and
    C launch their fp32 variants (LN1, the partition, LN2 and the MLP in
    torch), within ``F32_ENCODER_TOL`` of plain fp32."""
    from rsprompter_tpu_torch.apis.build import init_random_weights
    from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
    from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder

    cfg = SamVisionConfig(hidden_size=768, num_hidden_layers=2, num_attention_heads=12,
                          global_attn_indexes=(1,), image_size=160, window_size=4)
    enc = SamVisionEncoder(cfg, attn_impl="flash")
    init_random_weights(enc, 1)
    enc.to("cuda").eval()
    x = torch.randn(2, 160, 160, 3, generator=gen).to("cuda")
    kernels = (fm.QKV_HEADMAJOR, fa.RELPOS_ATTENTION, fm.LN_QKV_HEADMAJOR, fm.LN_MLP_RESIDUAL)
    for k in kernels:
        k.reset_counts()
    with torch.no_grad():
        got = enc(x)
        launched = [dict(k.variant_launches) for k in kernels]
        enc.impl = "plain"
        ref = enc(x)
    assert [sum(c.values()) for c in launched] == [2, 2, 0, 0], launched
    assert all(v.endswith("/f32") for c in launched for v in c), launched
    for a, b in zip((got[0],) + got[1], (ref[0],) + ref[1]):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        err = (a - b).abs().max().item()
        assert err <= F32_ENCODER_TOL * b.abs().max().item(), err


# --- the ViT-L and ViT-H widths ---------------------------------------------


@pytest.mark.parametrize("c", [1024, 1280])
@pytest.mark.parametrize("t", [300, 4096])
def test_ln_mlp_residual_wide(gen, c, t):
    """Kernel A at ViT-L's and ViT-H's widths (M = 4 C), at a row count that
    is not a multiple of the GEMMs' 128-row tile."""
    m = 4 * c
    args = (_rnd(gen, t, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
            _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, m, c, scale=0.02),
            _rnd(gen, m, scale=0.02), _rnd(gen, c, m, scale=0.02), _rnd(gen, c, scale=0.02),
            1e-6)
    _close(fm.ln_mlp_residual(*args), fm.ln_mlp_residual_plain(*_f32(args)))


@pytest.mark.parametrize("c,heads", [(1024, 16), (1280, 16), (320, 4)])
@pytest.mark.parametrize("grid,window", [((10, 9), 0), ((10, 9), 4), ((15, 14), 14)])
def test_ln_qkv_headmajor_wide(gen, c, heads, grid, window):
    """Kernel B with 16 heads of 64 (ViT-L) and of 80 (ViT-H), and four heads
    of 80 (960 columns: 80-wide heads straddle the GEMM's 256-column tiles
    and the last tile is partly past the weight), at ragged grids, global
    and windowed."""
    args = (
        _rnd(gen, 2, *grid, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
        _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, 3 * c, c, scale=0.02),
        _rnd(gen, 3 * c, scale=0.02), 3 * heads, window, 1e-6,
    )
    got = fm.ln_qkv_headmajor(*args)
    assert got.shape[-1] == c // heads
    _close(got, fm.ln_qkv_headmajor_plain(*_f32(args)))


@pytest.mark.parametrize("d,heads", [(80, 16), (80, 3), (64, 16)])
@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (1, 1), (16, 16), (32, 32)])
def test_relpos_attention_wide(gen, d, heads, hw):
    """Kernel C at head dim 80 (and 64 with ViT-L's 16 heads): the window
    path for S <= 200, the global one for (16, 16) and (32, 32); the output
    and the row log-sum-exp against plain, the scale d^-0.5."""
    s = hw[0] * hw[1]
    qkv = _rnd(gen, 3, 3 * heads, s, d)
    fh = _rnd(gen, 3, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, 3, heads, s, hw[1], scale=0.5)
    assert fa.relpos_attention_route(hw, d) == ("window" if s <= 200 else "global")
    out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
    qf = qkv.float()
    scores = fa._biased_scores(qf[:, :heads], qf[:, heads : 2 * heads], fh, fw)
    _close(out, fa.relpos_attention_plain(qf, fh.float(), fw.float(), hw))
    err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
    assert err <= 1e-3 * scores.abs().max().item(), err


def test_wrappers_refuse_widths_they_do_not_take(gen):
    """Kernel A and A' at C = 896, and kernels B, B', K12', C and C' at head
    dim 96, raise on CUDA tensors before any launch."""
    c = 896
    args = (_rnd(gen, 8, c), _rnd(gen, c, dtype=torch.float32),
            _rnd(gen, c, dtype=torch.float32), _rnd(gen, 4 * c, c), _rnd(gen, 4 * c),
            _rnd(gen, c, 4 * c), _rnd(gen, c))
    with pytest.raises(ValueError, match="unsupported widths"):
        fm.ln_mlp_residual(*args)
    with pytest.raises(ValueError, match="unsupported widths"):
        fm.ln_mlp_residual_bwd(*args, _rnd(gen, 8, c))
    x = _rnd(gen, 1, 4, 4, 256)
    w, b = _rnd(gen, 6 * 96, 256), _rnd(gen, 6 * 96)
    with pytest.raises(ValueError, match="head dim"):
        fm.ln_qkv_headmajor(x, None, None, w, b, 6)
    with pytest.raises(ValueError, match="head dim"):
        fm.qkv_headmajor(x.reshape(16, 256), w, b, 6, 1)
    with pytest.raises(ValueError, match="head dim"):
        fm.ln_qkv_headmajor_bwd(x, None, None, w, b, _rnd(gen, 1, 6, 16, 96), 6)
    qkv, fh, fw = _rnd(gen, 1, 6, 9, 96), _rnd(gen, 1, 2, 9, 3), _rnd(gen, 1, 2, 9, 3)
    with pytest.raises(ValueError, match="head dim"):
        fa.relpos_attention(qkv, fh, fw, (3, 3))
    with pytest.raises(ValueError, match="head dim"):
        fa.relpos_attention_bwd(qkv, fh, fw, _rnd(gen, 1, 2, 9, 96),
                                torch.zeros(1, 2, 9, device="cuda"), _rnd(gen, 1, 2, 9, 96),
                                (3, 3))


# --- the ViT-L and ViT-H backwards --------------------------------------------


@pytest.mark.parametrize("c", [1024, 1280])
@pytest.mark.parametrize("t", [300, 4096])
def test_ln_mlp_residual_bwd_wide(gen, c, t):
    """A' at ViT-L's and ViT-H's widths (M = 4 C; the row kernels' V = 4, 5),
    at a row count that is not a multiple of the 128-row tile."""
    args = (*_mlp_args(gen, t, c)[:7], _rnd(gen, t, c))
    _close_each(fm.ln_mlp_residual_bwd(*args, 1e-6),
                fm.ln_mlp_residual_bwd_plain(*_f32(args), 1e-6))


@pytest.mark.parametrize("c", [1024, 1280])
def test_ln_mlp_residual_bwd_wide_is_deterministic(gen, c):
    """Two launches of A' at C = 1024 and 1280 give the same bits in all
    seven outputs (the LN backward's column sums in warp order)."""
    args = (*_mlp_args(gen, 4096, c)[:7], _rnd(gen, 4096, c))
    first = fm.ln_mlp_residual_bwd(*args, 1e-6)
    second = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("window", [0, 14])
def test_ln_qkv_headmajor_bwd_hd80_is_deterministic(gen, window):
    args = _qkv_bwd_args(gen, 4, (32, 32), 1280, 16, window, True)
    first = fm.ln_qkv_headmajor_bwd(*args)
    second = fm.ln_qkv_headmajor_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (32, 32), (64, 64)])
def test_relpos_attention_bwd_hd80(gen, hw):
    """C' at head dim 80: the grids kernel C takes there, its window path's
    (14, 14) and (9, 7) (F's two halves in 64 columns) and its global
    path's (32, 32) and (64, 64) (the bias 128 and 256 deep, the group sums
    64 and 128 wide), against plain; the log-sum-exp is kernel C's."""
    n_img, heads = (1, 2) if hw == (64, 64) else (3, 4)
    qkv, fh, fw, out, lse, dout, _ = a = _bwd_inputs(gen, n_img, heads, hw, 80)
    assert fa.relpos_attention_route(hw, 80) == ("window" if hw[0] * hw[1] <= 200 else "global")
    _close_each(
        fa.relpos_attention_bwd(*a),
        fa.relpos_attention_bwd_plain(qkv.float(), fh.float(), fw.float(), dout.float(), hw),
    )


@pytest.mark.parametrize("hw", [(14, 14), (32, 32), (64, 64)])
def test_relpos_attention_bwd_hd80_is_deterministic(gen, hw):
    a = _bwd_inputs(gen, 2, 2, hw, 80)
    first = fa.relpos_attention_bwd(*a)
    second = fa.relpos_attention_bwd(*a)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n,s", [(1, 37), (5, 196), (2, 1024)])
def test_qkv_headmajor_hd80(gen, n, s):
    """K12' with 16 heads of 80 at C = 1280, ragged and ViT-H's row counts."""
    c, heads3 = 1280, 48
    args = (_rnd(gen, n * s, c), _rnd(gen, heads3 * 80, c, scale=0.02),
            _rnd(gen, heads3 * 80, scale=0.02), heads3, n)
    got = fm.qkv_headmajor(*args)
    assert got.shape == (n, heads3, s, 80)
    _close(got, fm.qkv_headmajor_plain(*_f32(args)))


@pytest.mark.parametrize("n,s", [(1, 37), (5, 196)])
def test_qkv_headmajor_lora_hd80(gen, n, s):
    """K12' with the adapter at head dim 80 (K = 1280 + 64), forward and
    every gradient against the plain version's autograd."""
    c, heads3, r = 1280, 48, 16
    args = (_rnd(gen, n * s, c), _rnd(gen, heads3 * 80, c, scale=0.02),
            _rnd(gen, heads3 * 80, scale=0.02), _rnd(gen, c, r, scale=1.0 / r),
            _rnd(gen, r, heads3 * 80, scale=0.02))
    leaves = [t.clone().requires_grad_(True) for t in args]
    got = fm.qkv_headmajor_lora(*leaves, 2.0, heads3, n)
    ref_leaves = [t.float().requires_grad_(True) for t in args]
    ref = fm.qkv_headmajor_lora_plain(*ref_leaves, 2.0, heads3, n)
    _close(got, ref)
    dy = _rnd(gen, *got.shape)
    got.backward(dy)
    ref.backward(dy.float())
    _close_each([t.grad for t in leaves], [t.grad for t in ref_leaves])


# --- the fp32 variants (3xTF32 on wgmma .tf32) ---------------------------------

F32_TOL = 1e-4


@pytest.fixture()
def tf32_off():
    """The plain fp32 references in full fp32: no TF32 in matmuls or convs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32_close_and_repeatable(run, plain):
    """The fp32 kernel within F32_TOL of its output's largest magnitude
    against plain fp32, and the same bits from a second launch."""
    got, again = run(), run()
    ref = plain()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= F32_TOL * ref.abs().max().item(), err
    assert torch.equal(got, again)


def _rf32(gen, *shape, scale=1.0):
    return _rnd(gen, *shape, scale=scale, dtype=torch.float32)


@pytest.mark.parametrize("t,c", [(100, 768), (8193, 768), (300, 1024), (4096, 1280)])
def test_ln_mlp_residual_rf32(gen, tf32_off, t, c):
    """Kernel A's fp32 variant (row pass, fc1 + GELU, fc2 + residual) at row
    counts off the GEMM's 128-row tile and at ViT-L's and ViT-H's widths."""
    m = 4 * c
    args = (_rf32(gen, t, c), 1 + _rf32(gen, c, scale=0.1), _rf32(gen, c, scale=0.1),
            _rf32(gen, m, c, scale=0.02), _rf32(gen, m, scale=0.02), _rf32(gen, c, m, scale=0.02),
            _rf32(gen, c, scale=0.02), 1e-6)
    _f32_close_and_repeatable(lambda: fm.ln_mlp_residual(*args),
                              lambda: fm.ln_mlp_residual_plain(*args))


@pytest.mark.parametrize("c,heads,grid,window", [
    (768, 12, (10, 9), 0), (768, 12, (10, 9), 4), (768, 12, (64, 64), 14),
    (1024, 16, (15, 14), 14), (1280, 16, (10, 9), 0), (1280, 16, (15, 14), 14),
    (320, 4, (10, 9), 4),
])
def test_ln_qkv_headmajor_rf32(gen, tf32_off, c, heads, grid, window):
    """Kernel B's fp32 variant, heads of 64 and of 80 (four heads of 80:
    960 columns, the last 128-column tile partly past the weight), global
    and windowed at ragged grids."""
    args = (_rf32(gen, 2, *grid, c), 1 + _rf32(gen, c, scale=0.1), _rf32(gen, c, scale=0.1),
            _rf32(gen, 3 * c, c, scale=0.02), _rf32(gen, 3 * c, scale=0.02), 3 * heads, window,
            1e-6)
    with torch.no_grad():
        _f32_close_and_repeatable(lambda: fm.ln_qkv_headmajor(*args),
                                  lambda: fm.ln_qkv_headmajor_plain(*args))


@pytest.mark.parametrize("grid,window,ln", [((10, 9), 4, True), ((64, 64), 14, True),
                                            ((10, 9), 0, True), ((15, 14), 14, False)])
def test_ln_rows_rf32(gen, tf32_off, grid, window, ln):
    """Kernel B's row pass at fp32 alone: LN (or none), the window map and
    its zero pad, at C 1280."""
    c = 1280
    x = _rf32(gen, 2, *grid, c)
    ln_w, ln_b = (1 + _rf32(gen, c, scale=0.1), _rf32(gen, c, scale=0.1)) if ln else (None, None)
    n_img, s = fm._qkv_rows(x, 3, window)

    def run():
        z = torch.empty((n_img * s, c), device="cuda")
        fm.LN_ROWS.launch(fm.ptr(x), fm.ptr(ln_w) if ln else fm._NULL,
                          fm.ptr(ln_b) if ln else fm._NULL, fm.ptr(z), 2, *grid, c, window,
                          1e-6, variant="test", f32=True)
        return z

    _f32_close_and_repeatable(run, lambda: fm.ln_rows_plain(x, ln_w, ln_b, window, 1e-6))


@pytest.mark.parametrize("d,heads,hw,n_img", [
    (64, 3, (14, 14), 5), (64, 5, (9, 7), 3), (64, 1, (1, 1), 2), (64, 4, (16, 16), 2),
    (64, 12, (64, 64), 1), (80, 16, (14, 14), 3), (80, 3, (9, 7), 2), (80, 16, (32, 32), 1),
    (80, 2, (64, 64), 1),
])
def test_relpos_attention_rf32(gen, tf32_off, d, heads, hw, n_img):
    """Kernel C's fp32 variant at head dims 64 and 80, odd and even head
    counts, window and global grids, ragged ones (a partial last key tile,
    factor rows of odd length)."""
    s = hw[0] * hw[1]
    qkv = _rf32(gen, n_img, 3 * heads, s, d)
    fh, fw = _rf32(gen, n_img, heads, s, hw[0], scale=0.5), _rf32(gen, n_img, heads, s, hw[1],
                                                                scale=0.5)
    _f32_close_and_repeatable(lambda: fa.relpos_attention(qkv, fh, fw, hw),
                              lambda: fa.relpos_attention_plain(qkv, fh, fw, hw))


@pytest.mark.parametrize("n,s,d", [(1, 37, 64), (5, 196, 64), (3, 100, 80), (2, 1024, 80)])
def test_qkv_headmajor_rf32(gen, tf32_off, n, s, d):
    """K12''s fp32 variant (the 'flash' route of an fp32 encoder)."""
    heads, c = 4, 256
    x, w = _rf32(gen, n * s, c), _rf32(gen, 3 * heads * d, c, scale=0.05)
    b = _rf32(gen, 3 * heads * d, scale=0.05)
    with torch.no_grad():
        _f32_close_and_repeatable(lambda: fm.qkv_headmajor(x, w, b, 3 * heads, n),
                                  lambda: fm.qkv_headmajor_plain(x, w, b, 3 * heads, n))


def test_f32_variants_count_apart_and_refuse_backward(gen):
    """A launch of an fp32 variant counts under its variant's name with
    '/f32'; the backward kernels take bf16 only, so an fp32 call that
    records a graph for them, or a backward on fp32 operands, raises."""
    hw = (9, 7)
    qkv = _rf32(gen, 1, 6, 63, 64)
    fh, fw = _rf32(gen, 1, 2, 63, 9), _rf32(gen, 1, 2, 63, 7)
    fa.RELPOS_ATTENTION.reset_counts()
    fa.relpos_attention(qkv, fh, fw, hw)
    assert fa.RELPOS_ATTENTION.variant_launches == {"window/f32": 1}
    with pytest.raises(ValueError, match="takes bf16"):
        fa.relpos_attention(qkv.requires_grad_(True), fh, fw, hw)
    args = _mlp_args(gen, 8)
    args = [a.float() if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="takes bf16"):
        fm.ln_mlp_residual_bwd(*args[:7], _rf32(gen, 8, 768))
