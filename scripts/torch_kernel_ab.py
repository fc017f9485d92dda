"""Time the port's kernel A, kernel B, K12', kernel C and its backward C'
from several source trees on one CUDA card, each tree the same way, so two
designs compare in one run.

    python scripts/torch_kernel_ab.py [--generic-copy DST] ROOT [ROOT ...]

Each ROOT is a directory holding an ``rsprompter_tpu_torch/`` package (this
repository's root, or an unpacked ``git archive`` of another commit); each
is timed in a subprocess of its own, in the order given (parent, change,
change, parent), its kernels built from its own sources into ``ROOT/build``.
Inputs are those of ``chip_smoke.py``'s kernel phases (forward kernels at
ViT-B 1024^2, batch 2; C' at the train step's 512^2, batch 4: global qkv
(4, 36, 1024, 64), windows (36, 36, 196, 64); bf16, seed 0), and every
output is first held against its fp32 plain version within 2e-2 of its
largest magnitude (C': each of dqkv, dfh, dfw). Each kernel gets four
readings:

- ``alone``: CUDA events around one call, median of 15 after 3 warm-up
  calls. The device also waits for the host's enqueue of that call.
- ``b2b``: CUDA events around 10 back-to-back calls, over 10, median of 15
  (``chip_smoke.py``'s ``cuda_time_ms``). The host's enqueue overlaps the
  device's work unless a call is shorter than it.
- ``device``: the device's busy time per call in a ``torch.profiler``
  trace of 20 back-to-back calls, host time left out.
- ``host``: the host's time per call, 50 calls enqueued without waiting
  for the device. Where it exceeds ``device``, ``b2b`` reads the host.

``--generic-copy DST`` first copies this tree's package to ``DST`` with
kernel C's register-held fw path (w = 64 or 32) taken out of its dispatch,
so every grid there takes the generic shared-memory factor path; time DST
beside this tree to see what that path costs at the 64 x 64 global grid.

Prints the card's name and power limit, one line per kernel and tree, and
one JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

TOL = 2e-2
KERNEL_C = os.path.join("rsprompter_tpu_torch", "csrc", "relpos_attention.cu")
WF_DISPATCH = (
    "  if (w == 64) return launch<64, LongTile>(qkv, args, N, st);\n"
    "  if (w == 32) return launch<32, LongTile>(qkv, args, N, st);\n"
)


def time_alone(fn, warmup: int = 3, iters: int = 15) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_b2b(fn, warmup: int = 3, iters: int = 15, repeat: int = 10) -> float:
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


def time_device(fn, iters: int = 20) -> float:
    """Device time per call: the union of the CUDA activity intervals in a
    ``torch.profiler`` trace of ``iters`` back-to-back calls, over ``iters``
    (the host's share of a call is left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / iters


def time_host(fn, iters: int = 50) -> float:
    """Host time per call: the wall clock over ``iters`` calls enqueued
    without a synchronisation (the device runs behind)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def worker(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from rsprompter_tpu_torch.ops import _cuda
    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    if not fm.__file__.startswith(root):
        raise RuntimeError(f"imported {fm.__file__}, not the package under {root}")
    _cuda.build([fm.LN_MLP_RESIDUAL, fm.LN_QKV_HEADMAJOR, fa.RELPOS_ATTENTION,
                 fa.RELPOS_ATTENTION_BWD])
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bsz, grid, c, heads, win = 2, 64, 768, 12, 14
    ln_w = 1 + rnd(c, scale=0.1, dtype=torch.float32)
    ln_b = rnd(c, scale=0.1, dtype=torch.float32)
    xg = rnd(bsz, grid, grid, c)
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    cases = {}  # name: (kernel call, plain call on fp32 inputs)
    t, mlp = bsz * grid * grid, 4 * c
    a = (rnd(t, c), ln_w, ln_b, rnd(mlp, c, scale=0.02), rnd(mlp, scale=0.02),
         rnd(c, mlp, scale=0.02), rnd(c, scale=0.02), 1e-6)
    cases["ln_mlp_residual"] = (
        lambda a=a: fm.ln_mlp_residual(*a),
        lambda a=a: fm.ln_mlp_residual_plain(
            *[v.float() if torch.is_tensor(v) else v for v in a]))
    for variant, window in (("global", 0), ("window", win)):
        a = (xg, ln_w, ln_b, wq, bq, 3 * heads, window, 1e-6)
        cases[f"ln_qkv_headmajor/{variant}"] = (
            lambda a=a: fm.ln_qkv_headmajor(*a),
            lambda a=a: fm.ln_qkv_headmajor_plain(
                *[v.float() if torch.is_tensor(v) else v for v in a]))
    for variant, n_img, s in (("global", bsz, grid * grid), ("window", bsz * 25, win * win)):
        a = (rnd(n_img * s, c), wq, bq, 3 * heads, n_img)
        cases[f"qkv_headmajor/{variant}"] = (
            lambda a=a: fm.qkv_headmajor(*a),
            lambda a=a: fm.qkv_headmajor_plain(
                *[v.float() if torch.is_tensor(v) else v for v in a]))
    for name, n_img, nh, hw in (("global", bsz, heads, (grid, grid)),
                                ("window", bsz * 25, heads, (win, win)),
                                ("odd-heads", bsz * 25, 3, (win, win))):
        s = hw[0] * hw[1]
        qkv = rnd(n_img, 3 * nh, s, 64)
        fh = rnd(n_img, nh, s, hw[0], scale=0.5)
        fw = rnd(n_img, nh, s, hw[1], scale=0.5)
        cases[f"relpos_attention/{name}"] = (
            lambda a=(qkv, fh, fw, hw): fa.relpos_attention(*a),
            lambda a=(qkv, fh, fw, hw): fa.relpos_attention_plain(
                a[0].float(), a[1].float(), a[2].float(), a[3]))
    # C' at the train step's shapes (ViT-B 512^2, batch 4), from the forward's
    # output and log-sum-exp
    for name, n_img, hw in (("global", 4, (32, 32)), ("window", 36, (win, win))):
        s = hw[0] * hw[1]
        qkv = rnd(n_img, 3 * heads, s, 64)
        fh = rnd(n_img, heads, s, hw[0], scale=0.5)
        fw = rnd(n_img, heads, s, hw[1], scale=0.5)
        dout = rnd(n_img, heads, s, 64)
        o, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
        cases[f"relpos_attention_bwd/{name}"] = (
            lambda a=(qkv, fh, fw, o, lse, dout, hw): fa.relpos_attention_bwd(*a),
            lambda a=(qkv, fh, fw, dout, hw): fa.relpos_attention_bwd_plain(
                a[0].float(), a[1].float(), a[2].float(), a[3].float(), a[4]))
    out = {}
    for name, (kernel, plain) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        err = 0.0
        for x, r in zip(got, ref):  # each output against its own scale
            e = (x.float() - r.float()).abs().max().item()
            if not torch.isfinite(x.float()).all() or e > TOL * r.float().abs().max().item():
                raise AssertionError(f"{root}: {name} disagrees with plain (max |diff| {e:.4g})")
            err = max(err, e)
        del got, ref, x, r
        out[name] = {"alone": time_alone(kernel), "b2b": time_b2b(kernel),
                     "device": time_device(kernel), "host": time_host(kernel),
                     "max_abs_err": err}
    return out


def generic_copy(dst: str) -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(here, "rsprompter_tpu_torch"),
                    os.path.join(dst, "rsprompter_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, KERNEL_C)
    with open(path) as f:
        src = f.read()
    if WF_DISPATCH not in src:
        raise RuntimeError(f"{KERNEL_C} has no register-held fw dispatch to take out")
    with open(path, "w") as f:
        f.write(src.replace(WF_DISPATCH, ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--generic-copy", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if args.generic_copy:
        generic_copy(args.generic_copy)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"{root}: worker failed")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"root": root, "ms": ms})
        for name, r in ms.items():
            print(f"{root:24s} {name:32s} alone {r['alone']:.4f} ms  b2b {r['b2b']:.4f} ms  "
                  f"device {r['device']:.4f} ms  host {r['host']:.4f} ms  "
                  f"max_abs_err {r['max_abs_err']:.4g}", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
