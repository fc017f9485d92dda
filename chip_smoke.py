"""GPU smoke check of the PyTorch/CUDA port (``rsprompter_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (every failure raises; the script exits non-zero and prints no result):

1. environment: card name and power limit, CUDA version; builds every kernel
   of the main path from ``rsprompter_tpu_torch/csrc`` (one nvcc per source,
   all started together) into ``build/kernels/``;
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at the shapes of the main path (SAM ViT-B, 1024^2, batch 2), bf16
   inputs from a seed against an fp32 plain reference, with the time of the
   kernel, of the plain version, of one PyTorch library call where one
   computes the same function, and the least time the card could take;
   kernel A is the row pass (LN) then its fc1 and fc2 GEMMs, kernel B its
   row pass (LN, window partition, zero pad) then the GEMM that K12' is too;
   the encoder's 'flash' route adds K12' (qkv without LN) at the windowed
   and global shapes and reports kernel C there under K10, and kernel C at
   three heads stands for K11; kernel C is also held against plain at
   ragged grids (9 x 7, 16 x 16);
3. main path: RSPrompter-anchor predict at ViT-B 1024^2, batch 2, bf16, with
   seeded random weights, through ``init_detector`` / ``inference_detector``;
   launch counters show that every encoder layer went through the kernels; the
   encoder is run once more through the plain versions and compared, and
   once with its rel-pos tables zeroed, to show that the comparison would
   see a kernel that dropped the attention bias;
4. backward kernels: A', B' (global, window) and C' (global, window) against
   their fp32 plain backwards at the train step's shapes (ViT-B, 512^2,
   batch 4), each output within 2e-2 of its largest magnitude, with kernel,
   plain, library and bound times (A' and B''s library time: autograd
   through their forwards composed of PyTorch calls); a second launch of A',
   B' and C' on the same inputs must give the same bits (their sums run in a
   fixed order); K12''s
   backward (torch products) through its Function against plain autograd;
5. train step, the second main path: ``build_trainer`` on
   ``rsprompter_anchor-nwpu-scratch-512.py`` (encoder and decoder trainable,
   ViT-B 512^2, batch 4, bf16 compute on fp32 master weights), seeded random
   weights and synthetic images with ground truth; one warm-up step and 10
   timed steps; every loss and the gradient norm finite, every trained
   parameter reached by the loss has a finite gradient and moves; launch
   counts per step of A, B, C and A', B', C';
6. gradient check: one batch with the same draws and proposals through the
   kernels, through the plain versions, and through the plain versions with
   the encoder in fp32 (the reference); every parameter's gradient compared
   on its own, the kernels' distance from the reference held to twice the
   plain bf16 run's (the noise floor); the encoder alone through kernels and
   plain with the same cotangents, which sees the backward kernels without
   the heads' amplified bf16 noise, each of its tensors held to a limit;
7. query predict: RSPrompter-query at ViT-B 1024^2, batch 2, on both encoder
   routes ('fused', 'flash'): launch counts, the routes against each other
   and against plain, the last layer's logits against plain;
8. the SAM checkpoint: a seeded HF-named ViT-B SAM state_dict written to a
   temporary directory, the anchor detector built through ``init_detector``
   with a config whose ``hf_sam_pretrain_ckpt_path`` names it; every SAM
   tensor on the card must equal the file's after the dtype cast;
9. the evaluation path: ``python -m rsprompter_tpu_torch.tools.test``'s
   main on ``rsprompter_anchor-nwpu.py`` (ViT-B 1024^2, batch 2, bf16) over
   a synthetic NWPU-named COCO set (seven PNGs of 700 x 900 to 1000 x 1000
   written with zlib, polygon, RLE and crowd GT, one image without GT) in a
   temporary directory, with a seeded reference-named (mmengine) checkpoint
   of the whole detector; the detector's tensors must equal the file's, each
   forward must launch A, B and C as phase 3 counts, every metric key of
   JAX's tool must be finite, the GT fed as detections must read mAP 1.0,
   and the RLE library must equal its plain versions on the loop's masks;
   prints the loop's images/s and its split (decode, predict, process,
   compute).

It prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "rsprompter", "rsprompter_anchor-nwpu.py")
QUERY_CONFIG = os.path.join(ROOT, "configs", "rsprompter", "rsprompter_query-nwpu.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "rsprompter", "rsprompter_anchor-nwpu-scratch-512.py")
TRAIN_STEPS_PER_EPOCH = 130  # NWPU's 520 training images at batch 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = 2e-2  # max |kernel - plain| relative to max |plain| (bf16 inputs)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 3, iters: int = 15, repeat: int = 10) -> float:
    """Per-call device time: CUDA events around ``repeat`` back-to-back calls,
    the elapsed time over ``repeat``, median of ``iters`` such runs after a
    warm-up. Back to back, the host enqueues the next call while the device
    runs this one, so a call's host-side work (the wrappers' checks, the
    tensor-map encoding) stays out of the time unless the call is shorter
    than it. (Timing each call alone also counts the device's wait for the
    host's enqueue.)"""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref) -> float:
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if err > TOL * scale:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.4g} exceeds {TOL} x {scale:.4g}"
        )
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(dev):
    import torch

    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    rows = []
    bsz, grid, c, heads, mlp, win = 2, 64, 768, 12, 3072, 14
    t = bsz * grid * grid

    # --- kernel A: ln_mlp_residual ------------------------------------------
    x = rnd(t, c)
    ln_w, ln_b = 1 + rnd(c, scale=0.1, dtype=torch.float32), rnd(c, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(mlp, c, scale=0.02), rnd(mlp, scale=0.02)
    w2, b2 = rnd(c, mlp, scale=0.02), rnd(c, scale=0.02)
    args = (x, ln_w, ln_b, w1, b1, w2, b2, 1e-6)
    got = fm.ln_mlp_residual(*args)
    torch.cuda.synchronize()
    ref = fm.ln_mlp_residual_plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    err = compare("ln_mlp_residual", got, ref)
    plain_args = args
    flops = 4.0 * t * c * mlp
    nbytes = 2 * t * c * 2 + 2 * c * mlp * 2 + (mlp + c) * 2 + 2 * c * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    # its three launches alone: the row pass, fc1 + GELU, fc2 + residual
    z, hid, out = torch.empty_like(x), torch.empty((t, mlp), dtype=x.dtype, device=dev), \
        torch.empty_like(x)
    parts = {
        "row pass": lambda: fm.LN_ROWS.launch(fm.ptr(x), fm.ptr(ln_w), fm.ptr(ln_b), fm.ptr(z),
                                              1, 1, t, c, 0, 1e-6, variant="check"),
        "fc1": lambda: fm.LN_MLP_RESIDUAL.launch(fm.ptr(z), fm.ptr(w1), fm.ptr(b1), fm._NULL,
                                                 fm.ptr(hid), t, mlp, c, 0, variant="check"),
        "fc2": lambda: fm.LN_MLP_RESIDUAL.launch(fm.ptr(hid), fm.ptr(w2), fm.ptr(b2),
                                                 fm.ptr(x), fm.ptr(out), t, c, mlp, 1,
                                                 variant="check"),
    }
    log("kernel A's launches alone (ms): " + ", ".join(
        f"{k} {cuda_time_ms(f):.4f}" for k, f in parts.items()))
    del z, hid, out
    ln_wb, ln_bb = ln_w.to(x.dtype), ln_b.to(x.dtype)
    F = torch.nn.functional

    def library_a():  # composed of bf16 PyTorch calls: LN -> fc1 -> exact GELU -> fc2 + residual
        z = F.layer_norm(x, (c,), ln_wb, ln_bb, 1e-6)
        return x + F.linear(F.gelu(F.linear(z, w1, b1), approximate="none"), w2, b2)

    torch.testing.assert_close(library_a().float(), ref, atol=TOL * ref.abs().max().item(), rtol=0)
    rows.append(dict(
        name="ln_mlp_residual", kernel=fm.LN_MLP_RESIDUAL, variant="fc1",
        route="cuda", source="rsprompter_tpu_torch/csrc/ln_mlp_residual.cu",
        replaces="rsprompter_tpu/ops/fused_mlp.py:54",
        shape=f"x ({t}, {c}) bf16, W1 {c}x{mlp}, W2 {mlp}x{c}",
        max_abs_err=err,
        ms=cuda_time_ms(lambda: fm.ln_mlp_residual(*args)),
        plain_ms=cuda_time_ms(lambda: fm.ln_mlp_residual_plain(*plain_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_time_ms(library_a),
    ))

    # --- kernel B: ln_qkv_headmajor (row pass + GEMM), global and window ---
    xg = rnd(bsz, grid, grid, c)
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    for variant, window, replaces in (
        ("global", 0, "rsprompter_tpu/ops/fused_mlp.py:143"),
        ("window", win, "rsprompter_tpu/ops/fused_mlp.py:604"),
    ):
        # the row pass alone (LN, window partition, zero pad into z)
        n_img, s = fm._qkv_rows(xg, 3 * heads, window)
        z = torch.empty((n_img * s, c), dtype=torch.bfloat16, device=dev)

        def row_pass(z=z, window=window):
            fm.LN_ROWS.launch(fm.ptr(xg), fm.ptr(ln_w), fm.ptr(ln_b), fm.ptr(z), bsz, grid,
                              grid, c, window, 1e-6, variant="check")

        row_pass()
        torch.cuda.synchronize()
        err = compare(f"ln_rows/{variant}", z,
                      fm.ln_rows_plain(xg.float(), ln_w, ln_b, window, 1e-6))
        b_ms, b_by = bound_ms(0.0, xg.numel() * 2 + z.numel() * 2 + 2 * c * 4)
        rows.append(dict(
            name=f"ln_rows/{variant}", kernel=fm.LN_ROWS, variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor.cu", replaces=replaces,
            shape=f"x ({bsz}, {grid}, {grid}, {c}) -> z {tuple(z.shape)} bf16",
            max_abs_err=err, ms=cuda_time_ms(row_pass),
            plain_ms=cuda_time_ms(lambda window=window: fm.ln_rows_plain(
                xg, ln_w, ln_b, window, 1e-6)),
            bound_ms=b_ms, bound_by=b_by,
            # global: one call (LN); window: LN, then the partition and pad
            library_ms=cuda_time_ms(lambda window=window: fm.window_partition(
                F.layer_norm(xg, (c,), ln_wb, ln_bb, 1e-6), window).contiguous()),
        ))
        a = (xg, ln_w, ln_b, wq, bq, 3 * heads, window, 1e-6)
        got = fm.ln_qkv_headmajor(*a)
        torch.cuda.synchronize()
        ref = fm.ln_qkv_headmajor_plain(*[v.float() if torch.is_tensor(v) else v for v in a])
        err = compare(f"ln_qkv_headmajor/{variant}", got, ref)

        def library_b(window=window, shape=got.shape):
            # composed of bf16 PyTorch calls: LN -> window partition and zero
            # pad (window layers) -> qkv -> head-major copy
            z = fm.window_partition(F.layer_norm(xg, (c,), ln_wb, ln_bb, 1e-6), window)
            return F.linear(z, wq, bq).reshape(shape[0], shape[2], shape[1], 64).permute(
                0, 2, 1, 3).contiguous()

        torch.testing.assert_close(library_b().float(), ref, atol=TOL * ref.abs().max().item(),
                                   rtol=0)
        flops = 2.0 * t * c * 3 * c
        nbytes = t * c * 2 + 3 * c * c * 2 + 3 * c * 2 + 2 * c * 4 + got.numel() * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=f"ln_qkv_headmajor/{variant}", kernel=fm.LN_QKV_HEADMAJOR,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor.cu",
            replaces=replaces,
            shape=f"x ({bsz}, {grid}, {grid}, {c}) -> {tuple(got.shape)} bf16",
            max_abs_err=err,
            ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor(*a)),
            plain_ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_time_ms(library_b),
        ))

    # --- kernel C: relpos_attention, global and window ----------------------
    for variant, n_img, hw, replaces in (
        ("global", bsz, (grid, grid), "rsprompter_tpu/ops/fused_vit_attention.py:472"),
        ("window", bsz * 25, (win, win), "rsprompter_tpu/ops/fused_vit_attention.py:421"),
    ):
        s = hw[0] * hw[1]
        qkv = rnd(n_img, 3 * heads, s, 64)
        fh = rnd(n_img, heads, s, hw[0], scale=0.5)
        fw = rnd(n_img, heads, s, hw[1], scale=0.5)
        got = fa.relpos_attention(qkv, fh, fw, hw)
        torch.cuda.synchronize()
        ref = fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw)
        err = compare(f"relpos_attention/{variant}", got, ref)
        q, k, v = qkv[:, :heads], qkv[:, heads : 2 * heads], qkv[:, 2 * heads :]
        bias = (fh[..., :, None] + fw[..., None, :]).reshape(n_img, heads, s, s)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=bias))
        del bias
        flops = 4.0 * n_img * heads * s * s * 64
        nbytes = qkv.numel() * 2 + fh.numel() * 2 + fw.numel() * 2 + got.numel() * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=f"relpos_attention/{variant}", kernel=fa.RELPOS_ATTENTION,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/relpos_attention.cu",
            replaces=replaces,
            shape=f"qkv {tuple(qkv.shape)} bf16, factors h={hw[0]} w={hw[1]}",
            max_abs_err=err,
            ms=cuda_time_ms(lambda: fa.relpos_attention(qkv, fh, fw, hw)),
            plain_ms=cuda_time_ms(lambda: fa.relpos_attention_plain(qkv, fh, fw, hw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))

    # --- K10': kernel C on the 'flash' route, at K3's and K5's shapes --------
    flash_replaces = {"global": "rsprompter_tpu/ops/flash_attention.py:37",
                      "window": "rsprompter_tpu/ops/flash_attention.py:101"}
    for r in [r for r in rows if r["kernel"] is fa.RELPOS_ATTENTION]:
        rows.append(dict(r, name=f"relpos_attention/flash-{r['variant']}",
                         replaces=flash_replaces[r["variant"]], path="query_flash"))

    # --- K11': kernel C at an odd head count (three heads, window shape) ----
    heads3, n_img, hw = 3, bsz * 25, (win, win)
    s = hw[0] * hw[1]
    qkv = rnd(n_img, 3 * heads3, s, 64)
    fh = rnd(n_img, heads3, s, hw[0], scale=0.5)
    fw = rnd(n_img, heads3, s, hw[1], scale=0.5)
    got = fa.relpos_attention(qkv, fh, fw, hw)
    torch.cuda.synchronize()
    err = compare("relpos_attention/odd-heads", got,
                  fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw))
    q, k, v = qkv[:, :heads3], qkv[:, heads3 : 2 * heads3], qkv[:, 2 * heads3 :]
    bias = (fh[..., :, None] + fw[..., None, :]).reshape(n_img, heads3, s, s)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(q, k, v, attn_mask=bias))
    del bias
    b_ms, b_by = bound_ms(4.0 * n_img * heads3 * s * s * 64,
                          (qkv.numel() + fh.numel() + fw.numel() + got.numel()) * 2)
    rows.append(dict(
        name="relpos_attention/odd-heads", kernel=fa.RELPOS_ATTENTION, variant="window/odd",
        route="cuda", source="rsprompter_tpu_torch/csrc/relpos_attention.cu",
        replaces="rsprompter_tpu/ops/fused_vit_attention.py:254", path=None,
        shape=f"qkv {tuple(qkv.shape)} bf16, factors h={hw[0]} w={hw[1]}",
        max_abs_err=err, ms=cuda_time_ms(lambda: fa.relpos_attention(qkv, fh, fw, hw)),
        plain_ms=cuda_time_ms(lambda: fa.relpos_attention_plain(qkv, fh, fw, hw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    ))

    # --- kernel C at ragged grids, held against plain: 9 x 7 on the window
    # path (factor rows not 16-byte aligned, a key tile of 64), 16 x 16 past
    # its S <= 200 on the global path
    for hw in ((9, 7), (16, 16)):
        s = hw[0] * hw[1]
        qkv = rnd(n_img, 3 * heads, s, 64)
        fh = rnd(n_img, heads, s, hw[0], scale=0.5)
        fw = rnd(n_img, heads, s, hw[1], scale=0.5)
        err = compare(f"relpos_attention/window {hw}", fa.relpos_attention(qkv, fh, fw, hw),
                      fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw))
        log(f"kernel relpos_attention/window at {hw}: qkv {tuple(qkv.shape)}; max_abs_err "
            f"{err:.4g} (tol {TOL} x max|plain|); kernel "
            f"{cuda_time_ms(lambda: fa.relpos_attention(qkv, fh, fw, hw)):.4f} ms")

    # --- K12': qkv_headmajor (kernel B without LN), global and window -------
    for variant, n_img, s in (("global", bsz, grid * grid), ("window", bsz * 25, win * win)):
        xf = rnd(n_img * s, c)
        a = (xf, wq, bq, 3 * heads, n_img)
        got = fm.qkv_headmajor(*a)
        torch.cuda.synchronize()
        err = compare(f"qkv_headmajor/{variant}", got,
                      fm.qkv_headmajor_plain(*[v.float() if torch.is_tensor(v) else v for v in a]))

        def library(xf=xf, n_img=n_img, s=s):
            y = torch.nn.functional.linear(xf, wq, bq)
            return y.reshape(n_img, s, 3 * heads, 64).permute(0, 2, 1, 3).contiguous()

        b_ms, b_by = bound_ms(2.0 * n_img * s * c * 3 * c,
                              (xf.numel() + wq.numel() + bq.numel() + got.numel()) * 2)
        rows.append(dict(
            name=f"qkv_headmajor/{variant}", kernel=fm.QKV_HEADMAJOR, variant=variant,
            route="cuda", source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor.cu",
            replaces="rsprompter_tpu/ops/fused_mlp.py:154", path="query_flash",
            shape=f"x {tuple(xf.shape)} -> {tuple(got.shape)} bf16", max_abs_err=err,
            ms=cuda_time_ms(lambda: fm.qkv_headmajor(*a)),
            plain_ms=cuda_time_ms(lambda: fm.qkv_headmajor_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_time_ms(library),
        ))
    for r in rows:
        r.setdefault("path", "anchor_predict")
        log(f"kernel {r['name']}: {r['shape']}; max_abs_err {r['max_abs_err']:.4g} "
            f"(tol {TOL} x max|plain|); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the port's main path, RSPrompter-anchor predict
# ---------------------------------------------------------------------------

# 12 bf16 layers, kernels vs plain, max|diff| / max|plain| over the neck and
# the 13 hidden states: about twice the worst reading on an H100 (0.02105 with
# rel-pos tables at N(0, 0.5)); zeroing those tables moves it by 0.7484
ENCODER_TOL = 4e-2


def mlp_launches(n: int):
    """Kernel A's GEMM launches for ``n`` calls (its row pass counts under
    ``ln_rows`` as ``mlp``)."""
    return {"fc1": n, "fc2": n}


def worst_rel_diff(got, ref) -> float:
    """Largest max|got - ref| / max|ref| over the neck and hidden states."""
    (neck_a, hid_a), (neck_b, hid_b) = got, ref
    return max(
        (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        for a, b in zip((neck_a,) + tuple(hid_a), (neck_b,) + tuple(hid_b))
    )


def synthetic_images(seed: int):
    """Two uint8 BGR images of at least 800 px: smooth random fields plus
    noise, so the keep-ratio resize and the pad both act."""
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs = []
    for h, w in ((800, 1000), (960, 860)):
        coarse = rng.uniform(0, 255, (h // 40 + 1, w // 40 + 1, 3))
        field = np.kron(coarse, np.ones((40, 40, 1)))[:h, :w]
        imgs.append(np.clip(field + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8))
    return imgs


def main_path_phase(kernels, iters: int, profile_dir: str = ""):
    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector

    model = init_detector(CONFIG, device="cuda", batch_size=2, seed=0)
    det = model.model
    depth = det.backbone.config.num_hidden_layers
    n_global = len(det.backbone.config.global_attn_indexes)
    imgs = synthetic_images(0)
    preds = inference_detector(model, imgs)  # warm-up: cuBLAS/cuDNN handles
    torch.cuda.synchronize()

    for k in kernels:
        k.reset_counts()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        preds = inference_detector(model, imgs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k.name: dict(k.variant_launches) for k in kernels}

    per_kind = {"global": n_global * iters, "window": (depth - n_global) * iters}
    expect = {
        "ln_mlp_residual": mlp_launches(depth * iters),
        "ln_rows": dict(per_kind, mlp=depth * iters),
        "ln_qkv_headmajor": per_kind,
        "relpos_attention": per_kind,
        "qkv_headmajor": {},
    }
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"{name}: launches {counts[name]}, expected {want}")
    log(f"main path launches over {iters} forwards: {counts}")

    n_dets = []
    for img, p in zip(imgs, preds):
        h, w = img.shape[:2]
        boxes, scores, masks = p["bboxes"], p["scores"], p["masks"]
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError("non-finite detections")
        if len(boxes) == 0:
            raise AssertionError("no detections")
        if (boxes[:, [0, 2]].min() < -1e-3 or boxes[:, [0, 2]].max() > w + 1e-3
                or boxes[:, [1, 3]].min() < -1e-3 or boxes[:, [1, 3]].max() > h + 1e-3):
            raise AssertionError("boxes outside the image")
        if masks.shape != (len(boxes), h, w) or masks.dtype != np.bool_:
            raise AssertionError(f"masks {masks.shape} {masks.dtype} for image {h}x{w}")
        if not ((scores >= 0) & (scores <= 1)).all():
            raise AssertionError("scores outside [0, 1]")
        n_dets.append(len(boxes))
    ms = statistics.median(times)
    log(f"main path: RSPrompter-anchor predict, ViT-B 1024^2, batch 2, bf16: "
        f"{ms:.2f} ms/batch median of {iters} ({', '.join(f'{t:.2f}' for t in times)}), "
        f"{2e3 / ms:.3f} images/s; detections per image {n_dets}")

    # the encoder once more, through the plain versions, on the same batch
    batch, _ = model.make_batch(imgs)
    from rsprompter_tpu_torch.models.preprocess import preprocess_images

    x = preprocess_images(batch["images"])
    enc = det.backbone
    tables = [p for n, p in enc.named_parameters() if n.endswith(("rel_pos_h", "rel_pos_w"))]
    with torch.no_grad():
        out_k = enc(x)
        enc.impl = "plain"
        out_p = enc(x)
        plain_ms = cuda_time_ms(lambda: enc(x), warmup=1, iters=5)
        saved = [t.clone() for t in tables]
        for t in tables:
            t.zero_()
        out_nobias = enc(x)
        for t, v in zip(tables, saved):
            t.copy_(v)
        enc.impl = "kernel"
        kernel_ms = cuda_time_ms(lambda: enc(x), warmup=1, iters=5)
    if not all(torch.isfinite(a.float()).all() for a in (out_k[0],) + out_k[1]):
        raise AssertionError("encoder through the kernels: non-finite output")
    worst = worst_rel_diff(out_k, out_p)
    bias_effect = worst_rel_diff(out_nobias, out_p)
    log(f"encoder kernels vs plain on the card: worst max|diff|/max|plain| {worst:.4g} "
        f"over neck + {len(out_k[1])} hidden states (tol {ENCODER_TOL}); the same "
        f"measure with the rel-pos tables zeroed (plain): {bias_effect:.4g}; encoder "
        f"forward {kernel_ms:.2f} ms with kernels, {plain_ms:.2f} ms plain")
    if worst > ENCODER_TOL:
        raise AssertionError(f"encoder: kernels vs plain {worst:.4g} > {ENCODER_TOL}")
    if bias_effect < 2 * ENCODER_TOL:
        raise AssertionError(
            f"encoder: dropping the rel-pos bias moves the output by {bias_effect:.4g}, "
            f"too little for the {ENCODER_TOL} comparison to see")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inference_detector(model, imgs)
            torch.cuda.synchronize()
        os.makedirs(profile_dir, exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "main_path_profile.txt"), "w") as f:
            f.write(table)
        log(table[:6000])
    return counts


# ---------------------------------------------------------------------------
# phase 4: backward kernels against their plain backwards
# ---------------------------------------------------------------------------


def compare_each(name: str, got, ref) -> float:
    """Each output within TOL of its own largest magnitude; the worst
    absolute error."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            continue
        worst = max(worst, compare(f"{name}[{i}]", a, b))
    return worst


def sdpa_backward_ms(q, k, v, bias, dout):
    """``torch.autograd.grad`` through ``scaled_dot_product_attention`` with a
    materialised bf16 bias that requires grad (q, k, v and the bias), or
    None where the card's PyTorch has no such backward. Timed only."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
    try:
        out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
        return cuda_time_ms(
            lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
    except RuntimeError as err:  # no fused backward for a bias that needs grad
        log(f"library backward unavailable: {err}")
        return None


def composed_backward_ms(forward, inputs, cotangent):
    """``torch.autograd.grad`` with respect to every input through a forward
    composed of PyTorch calls, all in bf16, the forward run once outside the
    time: the library yardstick of a backward kernel that no single call
    computes. Timed only."""
    import torch

    leaves = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in inputs]
    out = forward(*leaves)
    return cuda_time_ms(lambda: torch.autograd.grad(out, leaves, cotangent, retain_graph=True))


def backward_kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    g = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def f32(args):
        return [a.float() if torch.is_tensor(a) else a for a in args]

    rows = []
    bsz, grid, c, heads, mlp, win = 4, 32, 768, 12, 3072, 14
    t = bsz * grid * grid
    ln_w = 1 + rnd(c, scale=0.1, dtype=torch.float32)
    ln_b = rnd(c, scale=0.1, dtype=torch.float32)

    # --- A': ln_mlp_residual_bwd ---------------------------------------------
    args = (rnd(t, c), ln_w, ln_b, rnd(mlp, c, scale=0.02), rnd(mlp, scale=0.02),
            rnd(c, mlp, scale=0.02), rnd(c, scale=0.02), rnd(t, c))
    got = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    err = compare_each("ln_mlp_residual_bwd", got, fm.ln_mlp_residual_bwd_plain(*f32(args), 1e-6))
    again = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    for name, x, y in zip(("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), got, again):
        if not torch.equal(x, y):
            raise AssertionError(
                f"ln_mlp_residual_bwd: a second launch changed {name} "
                f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
    log("ln_mlp_residual_bwd: a second launch gives the same bits in all seven outputs")
    del got, again
    flops = 5 * 2.0 * t * c * mlp  # fc1 recompute, dO W2, dW2, dW1, dh W1
    # read x, dO, W1, W2, b1, b2, LN params; write dx, dW1 / dW2 / db1 / db2
    # as A' writes them (bf16), dgamma, dbeta (fp32)
    nbytes = (3 * t * c * 2 + 2 * c * mlp * 2 + (mlp + c) * 2 + 2 * c * 4
              + 2 * c * mlp * 2 + (mlp + c) * 2 + 2 * c * 4)
    b_ms, b_by = bound_ms(flops, nbytes)
    library_ms = composed_backward_ms(  # LN -> fc1 -> exact GELU -> fc2 + residual
        lambda x, lw, lb, w1, b1, w2, b2: x + F.linear(F.gelu(F.linear(
            F.layer_norm(x, (c,), lw, lb, 1e-6), w1, b1), approximate="none"), w2, b2),
        args[:7], args[7])
    rows.append(dict(
        name="ln_mlp_residual_bwd", kernel=fm.LN_MLP_RESIDUAL_BWD, variant="",
        route="cuda", source="rsprompter_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
        replaces="rsprompter_tpu/ops/fused_mlp.py:483",
        shape=f"x, dO ({t}, {c}) bf16, W1 {mlp}x{c}, W2 {c}x{mlp}", max_abs_err=err,
        ms=cuda_time_ms(lambda: fm.ln_mlp_residual_bwd(*args, 1e-6)),
        plain_ms=cuda_time_ms(lambda: fm.ln_mlp_residual_bwd_plain(*args, 1e-6)),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    ))

    # --- B': ln_qkv_headmajor_bwd, global and window ---------------------------
    xg = rnd(bsz, grid, grid, c)
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    for variant, window, replaces in (
        ("global", 0, "rsprompter_tpu/ops/fused_mlp.py:334"),
        ("window", win, "rsprompter_tpu/ops/fused_mlp.py:707"),
    ):
        n_img, s = (bsz, grid * grid) if not window else (bsz * 9, win * win)
        dy = rnd(n_img, 3 * heads, s, 64)
        a = (xg, ln_w, ln_b, wq, bq, dy, 3 * heads, window, 1e-6)
        got = fm.ln_qkv_headmajor_bwd(*a)
        torch.cuda.synchronize()
        err = compare_each(f"ln_qkv_headmajor_bwd/{variant}", got,
                           fm.ln_qkv_headmajor_bwd_plain(*f32(a)))
        again = fm.ln_qkv_headmajor_bwd(*a)
        torch.cuda.synchronize()
        for name, x, y in zip(("dx", "dgamma", "dbeta", "dW", "db"), got, again):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"ln_qkv_headmajor_bwd/{variant}: a second launch changed {name} "
                    f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
        log(f"ln_qkv_headmajor_bwd/{variant}: a second launch gives the same bits in all "
            "five outputs")
        del got, again
        library_ms = composed_backward_ms(  # LN -> window partition -> qkv -> head-major
            lambda x, lw, lb, w, b, window=window, n_img=n_img, s=s: F.linear(
                fm.window_partition(F.layer_norm(x, (c,), lw, lb, 1e-6), window), w, b
            ).reshape(n_img, s, 3 * heads, 64).permute(0, 2, 1, 3),
            (xg, ln_w, ln_b, wq, bq), dy)
        # dW and dz over the t real tokens: window pad rows have z = 0 and feed
        # no token; only db reads their dy, a sum counted in the bytes
        flops = 2 * 2.0 * t * c * 3 * c
        nbytes = (2 * t * c * 2 + dy.numel() * 2 + 2 * 3 * c * c * 2 + 2 * 3 * c * 2
                  + 4 * c * 4)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=f"ln_qkv_headmajor_bwd/{variant}", kernel=fm.LN_QKV_HEADMAJOR_BWD,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor_bwd.cu", replaces=replaces,
            shape=f"x ({bsz}, {grid}, {grid}, {c}), dy {tuple(dy.shape)} bf16",
            max_abs_err=err, ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor_bwd(*a)),
            plain_ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor_bwd_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))

    # --- C': relpos_attention_bwd, global and window ---------------------------
    for variant, n_img, hw, replaces in (
        ("global", bsz, (grid, grid), "rsprompter_tpu/ops/fused_vit_attention.py:779"),
        ("window", bsz * 9, (win, win), "rsprompter_tpu/ops/fused_vit_attention.py:752"),
    ):
        s = hw[0] * hw[1]
        qkv = rnd(n_img, 3 * heads, s, 64)
        fh = rnd(n_img, heads, s, hw[0], scale=0.5)
        fw = rnd(n_img, heads, s, hw[1], scale=0.5)
        dout = rnd(n_img, heads, s, 64)
        out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
        a = (qkv, fh, fw, out, lse, dout, hw)
        got = fa.relpos_attention_bwd(*a)
        torch.cuda.synchronize()
        err = compare_each(f"relpos_attention_bwd/{variant}", got, fa.relpos_attention_bwd_plain(
            qkv.float(), fh.float(), fw.float(), dout.float(), hw))
        again = fa.relpos_attention_bwd(*a)
        torch.cuda.synchronize()
        for name, x, y in zip(("dqkv", "dfh", "dfw"), got, again):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"relpos_attention_bwd/{variant}: a second launch changed {name} "
                    f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
        log(f"relpos_attention_bwd/{variant}: a second launch gives the same bits "
            "in dqkv, dfh and dfw")
        del again
        q, k, v = qkv[:, :heads], qkv[:, heads : 2 * heads], qkv[:, 2 * heads :]
        bias = (fh[..., :, None] + fw[..., None, :]).reshape(n_img, heads, s, s)
        library_ms = sdpa_backward_ms(q, k, v, bias, dout)
        del bias
        flops = 5 * 2.0 * n_img * heads * s * s * 64  # q k^T again, dP, dV, dQ, dK
        nbytes = ((qkv.numel() + fh.numel() + fw.numel() + out.numel() + dout.numel()) * 2
                  + lse.numel() * 4 + (qkv.numel() + fh.numel() + fw.numel()) * 2)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=f"relpos_attention_bwd/{variant}", kernel=fa.RELPOS_ATTENTION_BWD,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/relpos_attention_bwd.cu", replaces=replaces,
            shape=f"qkv {tuple(qkv.shape)} bf16, factors h={hw[0]} w={hw[1]}",
            max_abs_err=err, ms=cuda_time_ms(lambda: fa.relpos_attention_bwd(*a)),
            plain_ms=cuda_time_ms(lambda: fa.relpos_attention_bwd_plain(
                qkv, fh, fw, dout, hw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))
    # --- K12''s backward (torch products, as JAX leaves it to XLA) through
    # the kernel's Function on the card, at the train step's windowed shape
    n_img, s = bsz * 9, win * win
    leaves = [t.requires_grad_(True) for t in (rnd(n_img * s, c), rnd(3 * c, c, scale=0.02),
                                               rnd(3 * c, scale=0.02))]
    dy = rnd(n_img, 3 * heads, s, 64)
    fm.qkv_headmajor(*leaves, 3 * heads, n_img).backward(dy)
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    fm.qkv_headmajor_plain(*ref, 3 * heads, n_img).backward(dy.float())
    err = compare_each("qkv_headmajor backward", [t.grad for t in leaves],
                       [t.grad for t in ref])
    log(f"K12' backward through the kernel's Function vs plain autograd: max_abs_err "
        f"{err:.4g} (tol {TOL} x max|plain| per gradient)")
    for r in rows:
        r["path"] = "train_step"
        log(f"kernel {r['name']}: {r['shape']}; max_abs_err {r['max_abs_err']:.4g} "
            f"(tol {TOL} x max|plain| per output); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return rows


# ---------------------------------------------------------------------------
# phases 5 and 6: the train step, and its gradients through the plain versions
# ---------------------------------------------------------------------------

# per-tensor max|kernels - plain| / max|plain| over every encoder parameter
# gradient of one bf16 train step (ViT-B 512^2, batch 4), both encoders given
# the same cotangents; about twice the worst readings on an H100 (0.03444,
# 0.03722)
GRAD_TOL = 7e-2
# Through the whole loss the neck and heads amplify the encoder's bf16 noise
# (a conv bias before a train-mode BatchNorm, whose true gradient is zero, is
# all rounding noise there), so no fixed limit holds. The plain bf16 step's
# distance from a reference step whose encoder computes in fp32 is the floor
# of that noise, measured in the same run; the kernels' step may be at most
# this many times as far from the reference, at the median tensor and at the
# worst one.
FLOOR_FACTOR = 2.0
# the loss never reaches the IoU head (RSPrompter trains no IoU target); JAX
# gives it zero gradients, the port none
UNREACHED = "roi_head.mask_head.mask_decoder.iou_prediction_head."


def device_busy_ms(prof) -> float:
    """Time the device was running any kernel in a profile: the union of the
    CUDA kernel intervals (events nest, so their sums double count)."""
    import torch

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def train_phase(kernels, iters: int, profile_dir: str = ""):
    import torch

    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    trainer = build_trainer(TRAIN_CONFIG, device="cuda", seed=0,
                            steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    model, opt = trainer.model, trainer.optimizer
    cfg = trainer.cfg
    bsz = cfg["train_dataloader"]["batch_size"]
    size = tuple(cfg["crop_size"])
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in synthetic_batch(
        bsz, size, cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    gen = torch.Generator(device="cuda")

    def check(metrics, when):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"train step {when}: non-finite {bad}")
        return {k: float(v) for k, v in metrics.items()}

    first = check(trainer.step(batch, gen.manual_seed(0)), "warm-up")
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in opt.trained}
    reached = set()
    for k in kernels:
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        metrics = trainer.step(batch, gen.manual_seed(1 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        reached |= {n for n, p in opt.trained} - set(opt.unreached)
        if set(opt.unreached) and not all(n.startswith(UNREACHED) for n in opt.unreached):
            raise AssertionError(f"train step: no gradient reached {opt.unreached}")
        last = check(metrics, f"{i + 1}")
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for n, p in opt.trained:
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"train step: {n} has no finite gradient")
        if n in reached and torch.equal(p.detach(), before[n]):
            raise AssertionError(f"train step: {n} was not updated")
    unreached = sorted(n for n, _ in opt.trained if n not in reached)

    depth = model.backbone.config.num_hidden_layers
    n_global = len(model.backbone.config.global_attn_indexes)
    per_kind = {"global": n_global * iters, "window": (depth - n_global) * iters}
    expect = {
        "ln_mlp_residual": mlp_launches(depth * iters),
        "ln_rows": dict(per_kind, mlp=depth * iters), "ln_qkv_headmajor": per_kind,
        "relpos_attention": per_kind, "ln_mlp_residual_bwd": {"": depth * iters},
        "ln_qkv_headmajor_bwd": per_kind, "relpos_attention_bwd": per_kind,
        "qkv_headmajor": {},
    }
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"train: {name} launches {counts[name]}, expected {want}")
    med = statistics.median(times)
    log(f"train step launches over {iters} steps: {counts}")
    log(f"train step: RSPrompter-anchor, ViT-B {size[0]}x{size[1]}, batch {bsz}, bf16 "
        f"compute, fp32 master weights, encoder and decoder trained: {med:.4f} s/step "
        f"median of {iters} (min {min(times):.4f}, max {max(times):.4f}), "
        f"{bsz / med:.3f} images/s; peak device memory {peak_gb:.2f} GiB; "
        f"{len(opt.trained)} trained / {len(opt.frozen)} frozen tensors; "
        f"not reached by the loss: {len(unreached)} ({UNREACHED}*)")
    log(f"train step 1 (warm-up): {json.dumps(first)}")
    log(f"train step {iters + 1}: {json.dumps(last)}")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.step(batch, gen.manual_seed(99))
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = device_busy_ms(prof)
        os.makedirs(profile_dir, exist_ok=True)
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50)
        with open(os.path.join(profile_dir, "train_step_profile.txt"), "w") as f:
            f.write(table)
        prof.export_chrome_trace(os.path.join(profile_dir, "train_step_trace.json"))
        log(f"train step profile: device busy {busy_ms:.2f} ms (union of kernel "
            f"intervals); profiled step wall {wall_ms:.2f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.4f}; against the unprofiled median step "
            f"{med * 1e3:.2f} ms, idle share {1 - busy_ms / (med * 1e3):.4f}")
        host = {e.key: f"{e.count} calls, {e.cpu_time_total / 1e3:.2f} ms"
                for e in prof.key_averages() if e.key in (
                    "cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")}
        log(f"train step profile, host side (profiled): {host}")
        log(table[:8000])

    gradient_phase(model, opt, lambda: model.loss(batch, generator=gen.manual_seed(7)))
    return counts


def relative_grad_diffs(got, ref):
    """Per tensor max|got - ref| / max(max|ref|, 1e-4 x the largest |ref|);
    the floor keeps a gradient that is zero up to rounding (a bias before a
    BatchNorm) from dividing by nothing."""
    import numpy as np

    if got.keys() != ref.keys():
        raise AssertionError("gradient check: the two runs reached different parameters")
    gmax = max(float(g.abs().max()) for g in ref.values())
    rel = {}
    for n, r in ref.items():
        err = float((got[n] - r).abs().max())
        if not np.isfinite(err):
            raise AssertionError(f"gradient check: {n} not finite")
        rel[n] = err / max(float(r.abs().max()), 1e-4 * gmax)
    return rel


def check_grads(what: str, rel, tol: Optional[float]) -> None:
    """Print the worst tensors; raise above ``tol`` (None: report only)."""
    worst = max(rel, key=rel.get)
    tables = [v for n, v in rel.items() if n.endswith(("rel_pos_h", "rel_pos_w"))]
    log(f"gradient check, {what}, per parameter tensor: worst {rel[worst]:.4g} at "
        f"{worst} (tol {tol}); median {statistics.median(rel.values()):.4g} over "
        f"{len(rel)} tensors; rel-pos tables worst {max(tables):.4g}; next worst: "
        + ", ".join(f"{n} {rel[n]:.4g}"
                    for n in sorted(rel, key=rel.get, reverse=True)[1:6]))
    if tol is not None and rel[worst] > tol:
        raise AssertionError(f"gradient check, {what}: {worst} {rel[worst]:.4g} > {tol}")


def gradient_phase(model, opt, loss_fn):
    """Phase 6. ``loss_fn()`` runs one batch with fixed draws through the
    whole loss three times: through the kernels, through the plain versions,
    and through the plain versions with the encoder computing in fp32 (the
    reference; its outputs are rounded to bf16, as the others', before the
    neck and heads read them). All three take the kernels' run's proposals:
    on random weights the RPN's top-k is full of near-ties that bf16 noise
    reorders, and the runs would otherwise sample different RoIs. Every
    parameter's gradient is compared on its own, and the kernels' distance
    from the reference is held to ``FLOOR_FACTOR`` times the plain bf16
    run's. The encoder is also run through the kernels and the plain
    versions with the same cotangents of its outputs, those of the kernels'
    run: that comparison sees the backward kernels alone, without the heads'
    amplification, and is held to ``GRAD_TOL``."""
    import torch

    from rsprompter_tpu_torch.apis.build import set_compute_dtype
    from rsprompter_tpu_torch.engine.train_state import total_loss
    from rsprompter_tpu_torch.models.detectors import rsprompter_anchor as det_mod

    enc = model.backbone
    seen = {}

    def cut(mod, inputs, outputs):  # the encoder's outputs become bf16 leaves
        leaves = [t.detach().to(torch.bfloat16).requires_grad_(True)
                  for t in (outputs[0],) + tuple(outputs[1])]
        seen["images"], seen["leaves"] = inputs[0].detach(), leaves
        return leaves[0], tuple(leaves[1:])

    def encoder_grads(impl, cot):
        enc.impl = impl
        enc.zero_grad(set_to_none=True)
        neck, hidden = enc(seen["images"])
        outs = (neck,) + tuple(hidden)
        torch.autograd.backward(outs, [c.to(o.dtype) for c, o in zip(cot, outs)])
        return {f"backbone.{n}": p.grad.float().clone() for n, p in enc.named_parameters()}

    def whole_loss_grads(impl):
        enc.impl = impl
        opt.zero_grad()
        hook = enc.register_forward_hook(cut)
        try:
            total_loss(loss_fn()).backward()
        finally:
            hook.remove()
        cot = [t.grad if t.grad is not None else torch.zeros_like(t) for t in seen["leaves"]]
        grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return {**grads, **encoder_grads(impl, cot)}, cot

    rpn_predict, kept = det_mod.rpn_predict, []

    def keep_first(*a, **kw):
        if not kept:
            kept.append(rpn_predict(*a, **kw))
        return kept[0]

    det_mod.rpn_predict = keep_first
    try:
        kernel, cot = whole_loss_grads("kernel")
        plain, _ = whole_loss_grads("plain")
        same_cot = encoder_grads("plain", cot)
        set_compute_dtype(enc, torch.float32, cast_params=False)
        ref, _ = whole_loss_grads("plain")
    finally:
        det_mod.rpn_predict = rpn_predict
        set_compute_dtype(enc, torch.bfloat16, cast_params=False)
        enc.impl = "kernel"
    floor = relative_grad_diffs(plain, ref)
    kernel_ref = relative_grad_diffs(kernel, ref)
    check_grads("whole loss, plain bf16 vs fp32-encoder reference (the floor)", floor, None)
    check_grads("whole loss, kernels vs fp32-encoder reference", kernel_ref, None)
    for what, stat in (("median", statistics.median), ("worst", max)):
        got, base = stat(kernel_ref.values()), stat(floor.values())
        msg = (f"gradient check, whole loss, {what} tensor: kernels {got:.4g} from the "
               f"reference, plain bf16 {base:.4g}; ratio {got / base:.4g} "
               f"(limit {FLOOR_FACTOR})")
        log(msg)
        if got > FLOOR_FACTOR * base:
            raise AssertionError(msg)
    check_grads("encoder with the same cotangents, kernels vs plain",
                relative_grad_diffs({n: kernel[n] for n in same_cot}, same_cot), GRAD_TOL)
    for n, g in same_cot.items():
        if n.endswith(("rel_pos_h", "rel_pos_w")) and float(g.abs().max()) == 0.0:
            raise AssertionError(f"gradient check: {n} has a zero gradient")


# ---------------------------------------------------------------------------
# phase 7: RSPrompter-query predict on both encoder routes
# ---------------------------------------------------------------------------

# The last decoder layer's class and mask logits through the kernels against
# the plain versions, max|diff| / max|plain| each: about twice the worst
# reading on an H100 (class 0.06723, mask 0.06696 on 'fused'; the bf16 noise
# of the encoder passes through six decoder layers whose attention masks
# threshold logits at 0, so single queries move).
QUERY_LOGIT_TOL = 0.15


def stage_ms(stages, run, iters: int = 5):
    """Stream time of each stage in one call of ``run``: CUDA events recorded
    when each of the stage's modules is entered and left, the intervals
    summed over the call (a module may run several times); the median over
    ``iters`` calls. It counts the stream's gaps inside a stage (host launch
    time) too, so it is the stage's share of the forward, not its busy time."""
    import torch

    events = {name: [] for name in stages}
    hooks = []
    for name, mods in stages.items():
        for mod in mods:
            def pre(_m, _a, name=name):
                events[name].append([torch.cuda.Event(enable_timing=True)])
                events[name][-1][0].record()

            def post(_m, _a, _o, name=name):
                events[name][-1].append(torch.cuda.Event(enable_timing=True))
                events[name][-1][1].record()

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    per_call = {name: [] for name in stages}
    try:
        for _ in range(iters):
            for ev in events.values():
                ev.clear()
            run()
            torch.cuda.synchronize()
            for name, ev in events.items():
                per_call[name].append(sum(a.elapsed_time(b) for a, b in ev))
    finally:
        for h in hooks:
            h.remove()
    return {name: statistics.median(v) for name, v in per_call.items()}


def rel_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()


def query_phase(kernels, iters: int, profile_dir: str = ""):
    """Returns {route: launch counts over the timed forwards}."""
    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.models.preprocess import preprocess_images

    models = {}
    for impl in ("fused", "flash"):
        cfg = Config.fromfile(QUERY_CONFIG)
        cfg.merge_from_options({"model.attn_impl": impl})
        weights = None if impl == "fused" else models["fused"].model.state_dict()
        models[impl] = init_detector(cfg, checkpoint=weights, device="cuda", batch_size=2,
                                     seed=0)
    vcfg = models["fused"].model.backbone.config
    depth, n_global = vcfg.num_hidden_layers, len(vcfg.global_attn_indexes)
    per_kind = {"global": n_global * iters, "window": (depth - n_global) * iters}
    expect = {
        "fused": {"ln_mlp_residual": mlp_launches(depth * iters),
                  "ln_rows": dict(per_kind, mlp=depth * iters),
                  "ln_qkv_headmajor": per_kind, "relpos_attention": per_kind,
                  "qkv_headmajor": {}},
        "flash": {"ln_mlp_residual": {}, "ln_qkv_headmajor": {},
                  "relpos_attention": per_kind, "qkv_headmajor": per_kind},
    }
    imgs = synthetic_images(0)
    counts, medians = {}, {}
    for impl, model in models.items():
        inference_detector(model, imgs)  # warm-up
        torch.cuda.synchronize()
        for k in kernels:
            k.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            preds = inference_detector(model, imgs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts[impl] = {k.name: dict(k.variant_launches) for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in kernels:
            want = expect[impl].get(k.name, {})
            if counts[impl][k.name] != want:
                raise AssertionError(f"query/{impl}: {k.name} launches "
                                     f"{counts[impl][k.name]}, expected {want}")
        n_dets = []
        for img, p in zip(imgs, preds):
            h, w = img.shape[:2]
            if not (np.isfinite(p["bboxes"]).all() and np.isfinite(p["scores"]).all()):
                raise AssertionError(f"query/{impl}: non-finite detections")
            if len(p["scores"]) == 0:
                raise AssertionError(f"query/{impl}: no detections")
            if p["masks"].shape != (len(p["scores"]), h, w) or p["masks"].dtype != np.bool_:
                raise AssertionError(f"query/{impl}: masks {p['masks'].shape}")
            if not ((p["scores"] >= 0) & (p["scores"] <= 1)).all():
                raise AssertionError(f"query/{impl}: scores outside [0, 1]")
            n_dets.append(len(p["scores"]))
        ms = medians[impl] = statistics.median(times)
        log(f"query predict, attn_impl={impl!r}: launches over {iters} forwards "
            f"{ {n: c for n, c in counts[impl].items() if c} }")
        log(f"query predict, attn_impl={impl!r}: RSPrompter-query, ViT-B 1024^2, batch 2, "
            f"bf16: {ms:.2f} ms/batch median of {iters} "
            f"({', '.join(f'{t:.2f}' for t in times)}), {2e3 / ms:.3f} images/s; peak "
            f"device memory {peak_gb:.2f} GiB; detections per image {n_dets}")

    # where the time of one forward goes, by stage, on each route
    batch, _ = models["fused"].make_batch(imgs)
    for impl, model in models.items():
        det = model.model
        head = det.panoptic_head
        stages = {
            "encoder": [det.backbone],
            "neck": [det.neck_feature_aggregator, det.neck_feature_spliter],
            "pixel decoder": [head.pixel_decoder],
            "Mask2Former decoder layers": list(head.transformer_decoder.layers),
            "dense prompts (SamMaskEmbedding)": [head.sam_mask_embed],
            "SAM mask decoder (140 prompts)": [head.mask_decoder],
            "query head": [head],
        }
        split = stage_ms(stages, lambda: det.predict(batch))
        whole = cuda_time_ms(lambda: det.predict(batch), warmup=1, iters=5)
        rest = split.pop("query head") - sum(split[k] for k in list(split)[2:])
        split["per-layer heads (class, prompts, masks, attention masks)"] = rest
        log(f"query/{impl}: stream ms per stage of model.predict ({whole:.2f} ms in all, "
            f"host image pipeline and mask finalisation excluded): "
            + "; ".join(f"{k} {v:.2f}" for k, v in split.items()))

    # the two routes' encoders, and each against its plain versions
    x = preprocess_images(batch["images"])
    out, enc_ms = {}, {}
    with torch.no_grad():
        for impl, model in models.items():
            enc = model.model.backbone
            for mode in ("kernel", "plain"):
                enc.impl = mode
                out[impl, mode] = enc(x)
                enc_ms[impl, mode] = cuda_time_ms(lambda: enc(x), warmup=1, iters=5)
            enc.impl = "kernel"
        enc = models["flash"].model.backbone
        tables = [t for n, t in enc.named_parameters() if n.endswith(("rel_pos_h", "rel_pos_w"))]
        saved = [t.clone() for t in tables]
        for t in tables:
            t.zero_()
        enc.impl = "plain"
        out_nobias = enc(x)
        enc.impl = "kernel"
        for t, v in zip(tables, saved):
            t.copy_(v)
    readings = {
        "flash vs fused (kernels)": worst_rel_diff(out["flash", "kernel"], out["fused", "kernel"]),
        "fused kernels vs plain": worst_rel_diff(out["fused", "kernel"], out["fused", "plain"]),
        "flash kernels vs plain": worst_rel_diff(out["flash", "kernel"], out["flash", "plain"]),
        "flash plain vs fused plain": worst_rel_diff(out["flash", "plain"], out["fused", "plain"]),
    }
    bias_effect = worst_rel_diff(out_nobias, out["flash", "plain"])
    log("query encoder, worst max|diff|/max|ref| over neck + 13 hidden states: "
        + "; ".join(f"{k} {v:.4g}" for k, v in readings.items())
        + f" (tol {ENCODER_TOL}); flash plain with the rel-pos tables zeroed {bias_effect:.4g}; "
        + "encoder forward ms: " + ", ".join(f"{i} {m} {t:.2f}" for (i, m), t in enc_ms.items()))
    for what, v in readings.items():
        if v > ENCODER_TOL:
            raise AssertionError(f"query encoder: {what} {v:.4g} > {ENCODER_TOL}")
    if bias_effect < 2 * ENCODER_TOL:
        raise AssertionError(f"query encoder: zeroing the rel-pos tables moves it by "
                             f"{bias_effect:.4g}, too little for the comparison to see")
    del out, out_nobias

    # the last layer's logits through the kernels against plain, and the
    # fusion head's outputs
    for impl, model in models.items():
        det = model.model
        cls_k, mask_k = det.predict_logits(batch)
        det.backbone.impl = "plain"
        cls_p, mask_p = det.predict_logits(batch)
        det.backbone.impl = "kernel"
        r_cls, r_mask = rel_diff(cls_k, cls_p), rel_diff(mask_k, mask_p)
        flip = ((mask_k > 0) != (mask_p > 0)).float().mean().item()
        log(f"query/{impl}: last-layer logits, kernels vs plain, max|diff|/max|plain|: class "
            f"{r_cls:.4g}, mask {r_mask:.4g} (tol {QUERY_LOGIT_TOL}); mask logits "
            f"{tuple(mask_k.shape)}, sign flips {flip:.3g}")
        if max(r_cls, r_mask) > QUERY_LOGIT_TOL:
            raise AssertionError(f"query/{impl}: logits kernels vs plain {r_cls:.4g} / "
                                 f"{r_mask:.4g} > {QUERY_LOGIT_TOL}")
        dets, probs = det.predict(batch)
        if not all(torch.isfinite(t.float()).all() for t in (dets.boxes, dets.scores, probs)):
            raise AssertionError(f"query/{impl}: non-finite detections")
        if probs.min().item() < 0 or probs.max().item() > 1:
            raise AssertionError(f"query/{impl}: mask probabilities outside [0, 1]")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        for impl, model in models.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                inference_detector(model, imgs)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
            with open(os.path.join(profile_dir, f"query_{impl}_profile.txt"), "w") as f:
                f.write(table)
            busy = device_busy_ms(prof)
            log(f"query/{impl} profile: device busy {busy:.2f} ms (union of kernel "
                f"intervals) in a profiled forward of {wall_ms:.2f} ms; against the "
                f"unprofiled median {medians[impl]:.2f} ms/batch, idle share "
                f"{1 - busy / medians[impl]:.4f}")
            host = {e.key: f"{e.count} calls, {e.cpu_time_total / 1e3:.2f} ms"
                    for e in prof.key_averages() if e.key in (
                        "cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")}
            log(f"query/{impl} profile, host side (profiled): {host}")
            log(table[:6000])
    return counts


# ---------------------------------------------------------------------------
# phase 8: the config's SAM checkpoint
# ---------------------------------------------------------------------------


def sam_checkpoint_phase(config: str = CONFIG, device: str = "cuda") -> int:
    """Write a seeded ViT-B SAM state_dict under Hugging Face's names (the
    anchor detector's SAM tensors at full width, 1024^2) to a temporary
    directory, build the anchor detector through ``init_detector`` with the
    config's ``hf_sam_pretrain_ckpt_path`` pointing at it, and fail unless
    every SAM tensor on the card equals the file's after the dtype cast.
    Returns the number of tensors compared."""
    import tempfile

    import torch

    from rsprompter_tpu_torch.apis.build import build_detector
    from rsprompter_tpu_torch.apis.inference import init_detector
    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.engine.checkpoint import SAM_SUBTREE_PREFIXES

    cfg = Config.fromfile(config)
    prefixes = SAM_SUBTREE_PREFIXES[cfg["model"]["type"]]
    g = torch.Generator().manual_seed(2)
    hf, names = {}, {}
    for name, t in build_detector(cfg["model"]).state_dict().items():
        for prefix, hf_prefix in prefixes.items():
            if name.startswith(prefix):
                key = hf_prefix + name[len(prefix):]
                hf[key] = 0.5 * torch.randn(t.shape, generator=g)
                names[name] = key
    n_params = sum(v.numel() for v in hf.values())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pytorch_model.bin")
        torch.save(hf, path)
        cfg.merge_from_options({"model.hf_sam_pretrain_ckpt_path": path})
        model = init_detector(cfg, device=device, batch_size=2, seed=0).model
    own = model.state_dict()
    wrong = [n for n, key in names.items()
             if not torch.equal(own[n].cpu(), hf[key].to(own[n].dtype))]
    if wrong or len(names) == 0:
        raise AssertionError(f"SAM checkpoint: {len(wrong)} of {len(names)} tensors differ "
                             f"from the file (first: {wrong[:3]})")
    dtypes = sorted({str(own[n].dtype) for n in names})
    log(f"SAM checkpoint: {len(names)} tensors ({n_params} values) of "
        f"{', '.join(p.rstrip('.') for p in prefixes)} loaded from the config's "
        f"hf_sam_pretrain_ckpt_path through init_detector; each equals the file's "
        f"after the cast to {'/'.join(dtypes)} on {device}")
    del model
    return len(names)


# ---------------------------------------------------------------------------
# phase 9: the evaluation path, ``rsprompter_tpu_torch.tools.test``
# ---------------------------------------------------------------------------

EVAL_SIZES = ((700, 900), (820, 960), (1000, 1000), (760, 930), (900, 1000), (980, 910),
              (850, 980))  # seven images: the last batch of two has a padded slot
NWPU_CLASSES = ("airplane", "ship", "storage_tank", "baseball_diamond", "tennis_court",
                "basketball_court", "ground_track_field", "harbor", "bridge", "vehicle")
# the port's names -> the reference's (mmengine) names of the anchor detector
TO_REFERENCE = (
    (r"^backbone\.", "backbone.vision_encoder."),
    (r"^shared_image_embedding\.", "shared_image_embedding.shared_image_embedding."),
    (r"^neck_feature_aggregator\.", "neck.feature_aggregator."),
    (r"^neck_feature_spliter\.", "neck.feature_spliter."),
    (r"\.mask_decoder\.", ".mask_decoder.mask_decoder."),
)
JAX_TOOL_KEYS = tuple(f"coco/{m}_mAP{s}" for m in ("bbox", "segm")
                      for s in ("", "_50", "_75", "_s", "_m", "_l"))


def write_png(path: str, img) -> None:
    """HWC uint8 BGR -> an 8-bit RGB PNG, rows filtered None, Sub, Up,
    Average and Paeth in turn, with zlib and struct (the card's machine has
    no image encoder)."""
    import struct
    import zlib

    import numpy as np

    rows = np.ascontiguousarray(img[:, :, ::-1]).reshape(img.shape[0], -1).astype(np.int16)
    a, b = np.zeros_like(rows), np.zeros_like(rows)  # left, up
    a[:, 3:], b[1:] = rows[:, :-3], rows[:-1]
    c = np.zeros_like(rows)  # up-left
    c[1:, 3:] = rows[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = np.arange(len(rows)) % 5
    pred = np.stack([np.zeros_like(rows), a, b, (a + b) >> 1, paeth])[kind, np.arange(len(rows))]
    body = (rows - pred) & 0xFF
    raw = np.concatenate([kind[:, None], body], 1).astype(np.uint8).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def reference_state_dict(model_cfg, seed: int):
    """A seeded state_dict of the whole detector under the reference's
    names, as mmengine saves it, and its values under the port's names:
    ``init_random_weights`` at ``seed``, BN statistics drawn too."""
    import re

    import torch

    from rsprompter_tpu_torch.apis.build import build_detector, init_random_weights

    model = build_detector(model_cfg)
    init_random_weights(model, seed)
    g = torch.Generator().manual_seed(seed)
    values = {}
    for name, t in model.state_dict().items():
        if name.endswith("running_mean"):
            t = 0.1 * torch.randn(t.shape, generator=g)
        elif name.endswith("running_var"):
            t = 0.5 + torch.rand(t.shape, generator=g)
        elif name.endswith("num_batches_tracked"):
            t = torch.tensor(12)
        values[name] = t.detach().clone()
    ref = {}
    for name, t in values.items():
        for pattern, repl in TO_REFERENCE:
            name = re.sub(pattern, repl, name, count=1)
        ref[name] = t
    return values, {"meta": {"epoch": 12, "seed": seed}, "state_dict": ref}


def eval_phase(kernels, config: str = CONFIG, device: str = "cuda") -> dict:
    """The evaluation path at full width: a synthetic NWPU-named COCO set of
    PNGs in a temporary directory and a reference-named checkpoint of the
    anchor detector (ViT-B 1024^2), through ``tools.test``'s main at batch
    2, bf16, on the card. Gates: the detector's tensors equal the file's
    after the cast; each forward's launches of A, B and C are phase 3's;
    every metric key of JAX's tool present and finite; the dataset's own GT
    fed as detections reads mAP 1.0; the RLE library equals its plain
    versions on the loop's masks. Returns the loop's timing."""
    import tempfile

    import numpy as np
    import torch

    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.data.coco import NWPUInsSegDataset
    from rsprompter_tpu_torch.data.io import imread
    from rsprompter_tpu_torch.evaluation import rle
    from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric, gt_from_raw_sample
    from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
    from rsprompter_tpu_torch.tools import test as tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t0 = time.time()
    lib = rle.build_library()  # a build failure fails the run
    log(f"RLE library {lib.name} ready in {time.time() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_coco(tmp, NWPU_CLASSES, EVAL_SIZES, write_png, seed=0)
        values, ckpt = reference_state_dict(Config.fromfile(config)["model"], seed=1)
        ckpt_path = os.path.join(tmp, "epoch_12.pth")
        torch.save(ckpt, ckpt_path)
        out_path = os.path.join(tmp, "results.json")
        dataset = NWPUInsSegDataset(ann_file="ann.json", data_root=tmp,
                                    data_prefix=dict(img="imgs"), test_mode=True)
        first = imread(dataset.data_list[0]["img_path"])
        log(f"evaluation set: {len(dataset)} PNGs of {EVAL_SIZES[0]}..{EVAL_SIZES[-1]} "
            f"(first decoded {first.shape}), "
            f"{sum(len(d['anns']) for d in dataset.data_list)} annotations, written in "
            f"{time.time() - t0:.2f} s with the checkpoint")

        for k in kernels:
            k.reset_counts()
        report = tool.main([
            config, ckpt_path, "--device", device, "--out", out_path, "--cfg-options",
            f"test_dataloader.dataset.data_root={tmp}",
            "test_dataloader.dataset.ann_file=ann.json",
            "test_dataloader.dataset.data_prefix.img=imgs",
        ])
        counts = {k.name: dict(k.variant_launches) for k in kernels}
        det = report["inferencer"].model
        timing, metrics = report["timing"], report["metrics"]
        n_batches = -(-len(dataset) // report["inferencer"].batch_size)

        # the checkpoint on the card
        own = det.state_dict()
        wrong = [n for n, v in values.items()
                 if not torch.equal(own[n].cpu(), v.to(own[n].dtype))]
        if wrong or own.keys() != values.keys():
            raise AssertionError(f"reference checkpoint: {len(wrong)} of {len(values)} "
                                 f"tensors differ from the file (first: {wrong[:3]})")
        log(f"reference checkpoint: {len(values)} tensors under mmengine names, loaded by "
            f"tools.test with no missing or unused key; each equals the file's after the "
            f"cast to {'/'.join(sorted({str(t.dtype) for t in own.values()}))}")

        # launches: each forward of the loop as phase 3 counts one
        depth = det.backbone.config.num_hidden_layers
        n_global = len(det.backbone.config.global_attn_indexes)
        per_kind = {"global": n_global * n_batches, "window": (depth - n_global) * n_batches}
        expect = {"ln_mlp_residual": mlp_launches(depth * n_batches),
                  "ln_rows": dict(per_kind, mlp=depth * n_batches),
                  "ln_qkv_headmajor": per_kind, "relpos_attention": per_kind}
        for name, want in expect.items():
            if counts[name] != (want if device == "cuda" else {}):
                raise AssertionError(f"evaluation: {name} launches {counts[name]}, "
                                     f"expected {want} over {n_batches} forwards")
        log(f"evaluation launches over {n_batches} forwards: "
            f"{ {n: c for n, c in counts.items() if c} }")

        # the metric keys of JAX's tool, present and finite
        bad = [k for k in JAX_TOOL_KEYS if not np.isfinite(metrics.get(k, float("nan")))]
        if bad:
            raise AssertionError(f"evaluation: metric keys missing or not finite: {bad}")

        # the dataset's own GT as detections reads mAP 1.0
        gt_metric = CocoMetric(num_classes=len(NWPU_CLASSES))
        for i in range(len(dataset)):
            raw = dataset.load_raw(i)
            gt = gt_from_raw_sample(raw)
            keep = ~gt["iscrowd"]
            n, (h, w) = int(keep.sum()), raw["ori_shape"]
            dets = DetResult(boxes=gt["bboxes"][keep][None], scores=np.ones((1, n), np.float32),
                             labels=gt["labels"][keep][None], valid=np.ones((1, n), bool))
            meta = dict(img_id=raw["img_id"], ori_shape=(h, w), scale_factor=(1.0, 1.0),
                        batch_input_shape=(h, w))
            gt_metric.process([meta], dets, (gt["masks"][keep] * 255)[None], [gt])
        self_ap = gt_metric.compute()
        if self_ap["coco/bbox_mAP"] != 1.0 or self_ap["coco/segm_mAP"] != 1.0:
            raise AssertionError(f"evaluation: the GT as detections reads {self_ap}")

        # the RLE library against its plain versions on the loop's masks
        t1 = time.time()
        with open(out_path) as f:
            dump = json.load(f)
        n_masks = n_pairs = 0
        for rec in dump["images"]:
            dets = [rle.RLE.from_coco(r) for r in rec["det"]["masks"]]
            gts = [rle.RLE.from_coco(r) for r in rec["gt"]["masks"]]
            if not dets:
                continue
            masks = np.stack([rle.decode_mask(r) for r in dets])
            for r, m in zip(dets, masks):
                if not np.array_equal(m, rle.decode_mask_plain(r)):
                    raise AssertionError("evaluation: decode_mask differs from its plain version")
            for a, b, c in zip(rle.encode_masks(masks), rle.encode_masks_plain(masks), dets):
                if not (np.array_equal(a.counts, b.counts) and np.array_equal(a.counts, c.counts)):
                    raise AssertionError("evaluation: encode_masks differs from its plain version")
            crowd = np.asarray(rec["gt"]["iscrowd"], bool)
            if gts and not np.array_equal(rle.iou_matrix(dets, gts, crowd),
                                          rle.iou_matrix_plain(dets, gts, crowd)):
                raise AssertionError("evaluation: iou_matrix differs from its plain version")
            n_masks += len(dets)
            n_pairs += len(dets) * len(gts)
    wall = timing["wall_s"]
    log(f"evaluation: RLE library equals plain on the loop's {n_masks} predicted masks "
        f"(decode, encode) and {n_pairs} det x GT IoUs, checked in {time.time() - t1:.2f} s; "
        f"the GT as detections reads bbox / segm mAP {self_ap['coco/bbox_mAP']} / "
        f"{self_ap['coco/segm_mAP']}")
    log(f"evaluation loop: RSPrompter-anchor, ViT-B 1024^2, batch 2, bf16, {timing['images']} "
        f"images in {wall:.3f} s, {timing['images'] / wall:.3f} images/s; decode + GT "
        f"{timing['load_s']:.3f} s (waiting on the loader, one batch decoded ahead), predict "
        f"{timing['predict_s']:.3f} s (to the host copy), metric.process "
        f"{timing['process_s']:.3f} s, compute {timing['compute_s']:.3f} s; device spans of "
        f"the {n_batches} predicts {timing['device_ms']:.2f} ms, device idle at least "
        f"{1 - timing['device_ms'] / 1e3 / wall:.4f} of the loop")
    log("evaluation metrics (random weights): " + json.dumps(metrics))
    del det, report
    return timing


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="timed forwards of the main path")
    parser.add_argument("--train-steps", type=int, default=10,
                        help="timed steps of the train step (after one warm-up)")
    parser.add_argument("--profile-dir", default="",
                        help="also write torch.profiler tables of one forward, one "
                             "train step and one query forward per route here")
    args = parser.parse_args()
    t_start = time.time()

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
        return 1
    from rsprompter_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kernels = _cuda.all_kernels()
    t0 = time.time()
    built = _cuda.build(kernels)
    log(f"built kernels in {time.time() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))

    rows = kernel_phase(dev)
    paths = {"anchor_predict": main_path_phase(kernels, args.iters, args.profile_dir)}
    rows += backward_kernel_phase(dev)
    paths["train_step"] = train_phase(kernels, args.train_steps, args.profile_dir)
    query = query_phase(kernels, args.iters, args.profile_dir)
    paths["query_fused"], paths["query_flash"] = query["fused"], query["flash"]
    sam_checkpoint_phase()
    eval_phase(kernels)
    out = []
    for r in rows:
        name, variant = r["kernel"].name, r["variant"]
        by_path = {p: c[name].get(variant, 0) for p, c in paths.items()}
        out.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"],
            # on its own path (K11': no path runs an odd head count)
            "launches": by_path[r["path"]] if r["path"] else 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "share_of_bound": r["bound_ms"] / r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "path": r["path"], "launches_by_path": by_path,
        })
    log(json.dumps({"kernels": out}))
    log(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
