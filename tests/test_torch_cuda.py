"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these build the kernels with nvcc and launch them, so they
skip where ``torch.cuda.is_available()`` is false. On a GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Shapes are small and ragged (row counts and grids that are not multiples of
the kernels' tiles) to reach the edge paths the main-path shapes do not;
``chip_smoke.py`` covers the main-path shapes. bf16 inputs, fp32 plain
reference, tolerance 2e-2 of the output's largest magnitude.
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


@pytest.mark.parametrize("t", [100, 4096])
def test_ln_mlp_residual_kernel(gen, t):
    c, m = 768, 3072
    args = (
        _rnd(gen, t, c), 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32),
        _rnd(gen, c, scale=0.1, dtype=torch.float32), _rnd(gen, m, c, scale=0.02),
        _rnd(gen, m, scale=0.02), _rnd(gen, c, m, scale=0.02), _rnd(gen, c, scale=0.02),
        1e-6,
    )
    _close(fm.ln_mlp_residual(*args), fm.ln_mlp_residual_plain(*_f32(args)))


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


@pytest.mark.parametrize("grid,window,ln", [
    ((10, 9), 0, True), ((10, 9), 4, True), ((32, 32), 14, True), ((10, 9), 4, False),
])
def test_ln_qkv_headmajor_bwd_kernel(gen, grid, window, ln):
    """Window grids that need padding; pad rows carry a non-zero dy."""
    c, heads = 256, 4
    x = _rnd(gen, 2, *grid, c)
    lw = 1 + _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    lb = _rnd(gen, c, scale=0.1, dtype=torch.float32) if ln else None
    w, b = _rnd(gen, 3 * c, c, scale=0.05), _rnd(gen, 3 * c, scale=0.05)
    dy = torch.randn_like(fm.ln_qkv_headmajor_plain(x, lw, lb, w, b, 3 * heads, window))
    args = (x, lw, lb, w, b, dy)
    _close_each(fm.ln_qkv_headmajor_bwd(*args, 3 * heads, window),
                fm.ln_qkv_headmajor_bwd_plain(*_f32(args), 3 * heads, window))


@pytest.mark.parametrize("hw", [(14, 14), (9, 7), (5, 13), (32, 32)])
def test_relpos_attention_bwd_kernel(gen, hw):
    """S = 196, 63, 65, 1024: key tiles of 64 end ragged in the first three."""
    n_img, heads, s = 3, 4, hw[0] * hw[1]
    qkv = _rnd(gen, n_img, 3 * heads, s, 64)
    fh = _rnd(gen, n_img, heads, s, hw[0], scale=0.5)
    fw = _rnd(gen, n_img, heads, s, hw[1], scale=0.5)
    dout = _rnd(gen, n_img, heads, s, 64)
    out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
    _close_each(
        fa.relpos_attention_bwd(qkv, fh, fw, out, lse, dout, hw),
        fa.relpos_attention_bwd_plain(qkv.float(), fh.float(), fw.float(), dout.float(), hw),
    )


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
