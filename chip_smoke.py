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
   compute);
10. the query train step: ``build_trainer`` on ``rsprompter_query-nwpu.py``
   (ViT-B 1024^2, batch 2, 70 queries, 12544 points, encoder frozen, bf16
   compute on fp32 master weights), seeded random weights and a synthetic
   batch with up to 7 GT an image; one warm-up step and 10 timed steps;
   all 35 loss terms and the gradient norm finite, every trained parameter
   the loss reaches has a finite gradient and moves, the encoder is
   unchanged and gets no gradient, A / B / C launch as the frozen forward
   counts and no backward kernel launches, each step's matches are
   one-to-one with -1 exactly at invalid GT; a gradient check on phase 6's
   rule (kernels, plain, and plain with the encoder in fp32, the matches,
   selected points and cross-attention masks held to the kernels' run's;
   each ratio's median over ``QUERY_GRAD_STATES`` trained states held to
   ``FLOOR_FACTOR``); prints s/step, images/s,
   peak memory, the Hungarian call's host time, and from one profiled step
   the device's busy time and idle share, launches and host syncs, and the
   ``grid_sample`` backward's device time; with ``--profile-dir`` the
   profile's table and the stream time by stage;
11. the training loop: ``python -m rsprompter_tpu_torch.tools.train``'s main
   on ``rsprompter_anchor-nwpu-scratch-512.py`` (ViT-B 512^2, batch 4, bf16
   on fp32 master weights, the train pipeline, two loader threads) over a
   synthetic NWPU-named COCO set in a temporary directory (16 train PNGs of
   700 x 900 to 1000 x 1000 and 4 val PNGs, polygon and RLE GT): 4 epochs
   of 4 steps, a checkpoint at steps 12 and 16 and a validation at the end;
   then a second main with ``--resume`` from the step-12 checkpoint alone,
   which must start at step 12 and the loader's epoch 3, run the fourth
   epoch and validate; then ``tools.test`` on its step-16 checkpoint. Gates:
   every logged loss finite; the restored model tensors and AdamW moments
   equal to the file's; the resumed run's step-16 parameters within Adam's
   step bound of the straight run's (2 x the summed learning rate x
   (|m/sqrt(v)| <= 3.17, plus the decay); the card's scatter-adds are not
   bitwise repeatable), its BN statistics finite; A, B, C, A', B', C' launched per step as phase 5 counts over
   one profiled epoch; ``tools.test``'s keys equal to the last validation's
   (the trainer's fp32 parameters, cast at each use, take the inferencer's
   bf16 values). Prints the loop's steps/s and images/s, the loader alone in
   images/s, a pinned and a pageable upload of one batch, the device's busy
   time and idle share over the profiled epoch, launches and syncs a step,
   peak memory, and the checkpoint's MB and save ms;
12. LoRA and the peft configs: K12' with the adapter folded into its K
   (``qkv_headmajor_lora``, K = C + 64) at the peft step's shapes (36
   windows of 196 rows, 4 images of 1024) against
   ``qkv_headmajor_lora_plain``, beside the other candidate (K12' and the
   adapter's two torch products added head-major), forward and forward +
   backward; then ``build_trainer`` on ``rsprompter_anchor-nwpu-peft-512.py``
   (ViT-B 512^2, LoRA r 16 alpha 32 on qkv, the pseudo aggregator, batch 4,
   bf16 on fp32 master weights) over a seeded 1024^2 HF-named SAM file
   written to a temporary directory (loaded through the 512^2 resize; the
   encoder's tensors equal to the file's, the adapters at their init), every
   ``qkv_lora_b`` then seeded non-zero; one warm-up step and 10 timed steps:
   every loss and the gradient norm finite, every trained tensor (the 24
   adapters, the neck and the heads) reached by the loss has a finite
   gradient and moves, every other tensor bitwise unchanged, A, C, A', C'
   and K12' 12 launches a step and B, B' none; one profiled step's busy
   time, launches and syncs; the gradient check of phase 6 on the trained
   tensors (the adapters' same-cotangent gradients held to its floor rule);
   then ``init_detector`` / ``inference_detector`` on the same config at
   batch 2 (launches; the encoder within ``ENCODER_TOL`` of plain, and
   plain with every ``qkv_lora_b`` zeroed moved by more than twice that);
   then 3 steps of ``rsprompter_query-nwpu-peft-512.py`` after a warm-up
   (finite, the adapters move and nothing else of the encoder, B and B'
   never launch);
13. SAM-det and the SAM-seg baselines: ``init_detector`` /
   ``inference_detector`` on ``samdet-nwpu.py`` (fp32; ResNet-50 + FPN +
   RPN + bbox head, its boxes prompting a complete SAM; the encoder's
   blocks through the fp32 kernels), ``samseg-maskrcnn-nwpu.py`` (bf16, the
   FCN head's RoI masks pasted into their boxes) and
   ``samseg-mask2former-nwpu.py`` (bf16, 70 queries, the stock head) at
   ViT-B 1024^2, batch 2, seeded weights, phase 3's images: a warm-up and
   10 timed forwards each (ms/batch, images/s, peak memory, the model's
   predict alone), A, B, C launched as phase 3 counts (SAM-det: their fp32
   variants, and no bf16 one), every output finite, one profiled forward's
   busy time, idle share, launches and syncs; for SAM-det its fp32 encoder
   through the fp32 kernels within ``F32_ENCODER_TOL`` of plain fp32 (TF32
   off), and ``oracle_predict`` on seeded GT (scores equal to valid,
   labels the GT's); for Mask R-CNN mask probabilities (2, 100, 28, 28),
   each pasted mask empty outside its box; then ``tools.test``'s main over
   phase 9's synthetic set with Mask R-CNN (paste; every key of JAX's tool
   finite) and with SAM-det ``--oracle`` (bbox mAP 1.0);
14. SAM-det and the SAM-seg baselines' train steps: ``build_trainer`` on
   each config over a seeded ViT-B SAM file, at 1024^2, batch 2, on phase
   3's images with phase 13's GT boxes and an ellipse mask in each; a
   warm-up and 10 timed steps each (every metric finite, every frozen
   tensor bitwise unchanged, every trained tensor the loss reaches moved;
   s/step, peak memory, and one profiled step's busy time, idle share,
   launches and syncs): SAM-det (fp32; the segmentor bitwise unchanged and
   without gradient, ResNet, FPN, RPN and bbox head moved, A, B and C
   launched neither by count nor in the profile); SAM-seg Mask R-CNN
   (A, B, C as the frozen forward counts, no backward kernel; the RoI
   gather's backward time a call; phase 6's gradient check on the trained
   tensors); the same with the anchor peft config's LoRA (3 timed steps:
   only the adapters move in the encoder, K12' with the adapter, C, A, C'
   and A' launch, B and B' none; phase 12's gradient check), then A', C'
   and K12' with the adapter against their plain versions at that step's
   shapes, listed in the ``kernels`` line under its path; for the three
   two-stage steps, the profiled step's RoI gathers' largest groups of one
   row (what the gather's backward time follows); SAM-seg Mask2Former (21 terms, the
   total the last call's three, one Hungarian solve a step, one-to-one);
   ``rsprompter_query-nwpu.py`` with ``decoder_plus=False`` (a predict
   through ``inference_detector``, then 2 steps with phase 10's gates and
   gradient check); then ``tools.train`` on Mask R-CNN over phase 9's PNGs
   (one epoch of 2 steps, a checkpoint, a validation with paste) and
   ``tools.test`` on its checkpoint, which must read the same keys;
15. the ViT-L and ViT-H widths: kernels A, B (and its row pass) and C at
   ViT-L's (C 1024, 16 heads of 64) and ViT-H's (C 1280, 16 heads of 80)
   shapes at 1024^2, batch 2, against their plain versions with phase 2's
   times and tolerance; each encoder (seeded; cast to bf16 as a bf16
   config predicts) against its plain fp32 copy within ``ENCODER_TOL``,
   with the launches of one forward, the path kernel C took for the
   windows and the global grid (the windows must take the window path at
   both head dims), and the rel-pos tables zeroed moving plain by more than
   twice the tolerance; then RSPrompter-anchor predict at ViT-H 1024^2,
   batch 2 (``rsprompter_anchor-nwpu.py`` with ``hf_sam_pretrain_name``
   ``facebook/sam-vit-huge``, seeded weights) through ``init_detector`` /
   ``inference_detector`` on phase 3's images, with phase 13's gates: A 32,
   B and C 28 window + 4 global launches a forward, every output finite,
   ms/batch, ``model.predict`` alone, peak memory, a profiled forward;
16. ViT-L and ViT-H training: A' at ViT-L's and ViT-H's widths (C 1024,
   1280), B' and C' at ViT-L's 16 heads of 64 and ViT-H's 16 heads of 80
   (global and window), at the train steps' shapes (512^2, batch 4), and
   K12' at head dim 80 alone at the 'flash' encoder's shapes (1024^2, batch
   2) and with the adapter at the peft step's, each against its fp32 plain
   version with phase 2's times and tolerance, A', B' and C' launched twice
   for the same bits;
   the ViT-H encoder on ``attn_impl='flash'`` (K12' and C at hd 80) against
   plain fp32 within ``ENCODER_TOL``; then three train steps through
   ``build_trainer``, seeded weights, batch 4, one warm-up and
   ``WIDE_TRAIN_STEPS`` timed steps each: ``rsprompter_anchor-nwpu-scratch-
   512.py`` at ``facebook/sam-vit-large`` and ``-huge`` (encoder and decoder
   trained) and ``rsprompter_anchor-nwpu-peft-512.py`` at ``-huge``, with
   phase 12's gates (finite metrics, trained tensors moved, frozen ones
   bitwise unchanged, exact launch counts, s/step, peak memory, a profiled
   step) and phase 6's gradient check, the encoder alone held to the floor
   rule at these depths (``GRAD_TOL`` holds ViT-B's);
17. the serving surface on ``rsprompter_anchor-nwpu.py`` (ViT-B 1024^2, bf16,
   seeded weights): every JPEG fixture of ``tests/data/jpeg/`` through the
   port's decoder, its sha256 equal to ``cv2.imread``'s (``digests.json``),
   the host ms a decode, OpenCV never imported; ``tools.image_demo``'s main
   over that directory (a drawn JPEG an image under the input's name at its
   shape, one ``predictions.json`` entry an image); ``tools.serve`` in-process on
   127.0.0.1 at a free port (``--max-batch 4 --size-buckets 512,1024
   --warmup --batch-window-ms 20``): 16 POSTs from 8 client threads mixing
   JPEG bytes, PNG bytes and ``{"path": ...}`` at both buckets, each answered
   200 and held against ``DetInferencer`` called directly on the same image
   at the same bucket (labels and counts equal; boxes, scores and decoded
   masks within ``SERVE_*_TOL``), ``/healthz`` counting 16 images in fewer
   batches, A, B and C launched per served forward as phase 3 counts and
   kernel C's window calls at 9 windows an image at 512 (25 at 1024),
   requests/s and p50 / p99 latency at concurrency 8 and 1; ``oom_guard``
   on a real ``torch.cuda.OutOfMemoryError`` (the allocator capped between
   a batch-2 and a batch-4 predict's reservation: batch 8 halved twice, the
   result equal to four unguarded batch-2 predicts bit for bit, the cap
   lifted after); ``tools.large_image_demo``'s main on a seeded 3400 x 2600
   PNG scene at ``--patch 1024 --overlap 0.25 --batch-size 4`` (as many
   patches as ``slice_offsets``, merged boxes inside the scene, the drawn
   PNG and ``predictions.json`` written); ``tools.test``'s main over the
   JPEG fixtures as a COCO set whose GT is written at run time, every key of
   JAX's tool finite;
18. the test tool's evaluation options and the analysis tools on
   ``rsprompter_anchor-nwpu.py`` (ViT-B 1024^2, batch 2, bf16, seeded
   weights): (a) the port's JPEG encoder, built by g++ here, gives
   ``cv2.imencode``'s bytes for every fixture's image at qualities 95 and 7
   (``tests/data/jpeg/encode_digests.json``), each file decoding to the
   image's shape, with its host ms an image; (b) flip TTA
   (``models.tta.make_tta_predict``) on phase 3's images (one narrower than
   the canvas): A, B and C launched exactly twice phase 3's per forward,
   the output equal bit for bit to ``merge_views`` of two separate
   ``model.predict`` calls, TTA and plain ms and images/s (CUDA events);
   A, B (its row pass too) and C held against their plain versions by
   phase 3's row builders on the inputs that the mirrored batch gives the
   encoder's first window and first global layer, in the ``kernels`` line
   under path ``tta_predict``; ``tools.test --tta``
   over phase 9's synthetic PNG set, A, B and C twice a forward's count
   per batch, every key of JAX's tool finite (this phase's evaluation runs
   keep ``TOOL_MAX_PER_IMG`` detections an image, for the metric's host
   time); (c) the host ms of every
   corruption at severity 3 on one fixture, and ``tools.test --corruption
   NAME --severity 3`` over the JPEG fixtures for ``jpeg_compression``
   (with ``--show-dir``: a JPEG under each image's name at its size),
   ``motion_blur`` and ``gaussian_noise``, every key finite; (d)
   ``Runner.validate()`` with ``vis_interval=1`` on the scratch-512
   trainer over the JPEG set writes ``vis/val_0.jpg`` and ``val_2.jpg`` at
   the images' sizes; (e) ``tools.analysis_tools.benchmark --task
   inference`` (batch 2) and ``get_flops`` (predict, 1024^2, batch 1,
   counted on the card over the encoder's plain route) print their numbers.
   OpenCV is never imported;
19. data parallelism and ``mode='tensor'``: A', B' and C' against their
   plain versions at a rank's shapes (512^2, batch 2; path
   ``dp_train_step``); (a) two ranks on card 0 over gloo
   (``parallel.launch``; NCCL refuses two ranks on one card), ZeRO on, run
   ``build_trainer`` on ``rsprompter_anchor-nwpu-scratch-512.py`` with two
   images a rank, against one process on the same four from the same
   weights, draws and (phase 6's reason) proposals: the metrics within
   ``DP_LOSS_TOL``, every trained gradient within ``DP_GRAD_TOL`` of its
   largest and the median within ``DP_GRAD_MEDIAN_TOL``, or else phase 6's
   rule: the median and the worst tensor within ``FLOOR_FACTOR`` times the
   bf16 noise floor measured on the one process's batch (phase 6's own
   runs, ``CutLossRuns``: its plain bf16 step against its step with the
   encoder in fp32); AdamW's moments after the step, which
   ``Trainer.state_dict()`` gathers from ZeRO's shards, held to the same
   rule against the one process's AdamW and equal bit for bit to their
   owners'; BatchNorm's statistics within ``DP_STATS_TOL`` and
   equal on both ranks, the parameters equal on both ranks bit for bit
   after ``DP_STEPS`` steps, each rank's launches of A, B, C, A', B', C' a
   step as phase 5 counts; then the two ranks run ``tools.test`` on phase
   9's set and checkpoint, each its block of the set, and the gathered
   metrics must be phase 9's within ``DP_METRIC_TOL`` with each image
   evaluated once; the step at world 1 (NCCL) without DDP, as the trainer
   takes it there, against DDP with ``find_unused_parameters`` and with
   ``static_graph``, and the bytes a step all-reduces; (b) ``python -m
   torch.distributed.run --standalone --nproc_per_node <cards>`` (NCCL)
   runs ``tools.train`` on phase 11's synthetic set (two epochs, then a
   resumed third with a validation) and ``tools.test`` on phase 9's set
   and checkpoint, whose metrics must be phase 9's within
   ``DP_METRIC_TOL`` with each image evaluated once (on one card that is
   world 1, where every collective is the identity: the launcher's
   environment, ``initialize()`` and NCCL's group are what it runs; (a)
   runs the collectives); (c)
   ``forward(batch, mode='tensor')`` of the anchor detector at ViT-B
   1024^2, batch 2, on phase 3's images: every output finite, JAX's order
   and shapes, A, B and C launched as phase 3 counts (path
   ``tensor_mode``);
20. the fp32 forwards (3xTF32 on wgmma ``.tf32``): kernel A, B's row pass,
   B and C at fp32, each against its plain fp32 version (TF32 off) within
   ``F32_TOL`` of the output's largest magnitude, at ViT-B's shapes at
   1024^2, batch 2 (SAM-det's fp32 encoder: their launches count on phase
   13's ``samdet_predict``) and at ViT-L's and ViT-H's widths, with the
   kernel, plain, library (the same composition of fp32 PyTorch calls,
   SDPA with the bias for C) and bound times (one TF32 pass: 3xTF32 makes
   three); then the ViT-L and ViT-H fp32 encoders (seeded, no gradient)
   through the fp32 kernels against plain fp32 within ``F32_ENCODER_TOL``,
   with their launches (fp32 variants only); and K10, K11 and K12' at fp32
   as phase 2 measures them in bf16 (C on the 'flash' route's shapes, C at
   three heads, B's fp32 GEMM alone), which no shipped path launches;
21. the WHU data path on a machine without OpenCV: every image-format
   fixture (``tests/data/formats``: PNG and TIFF forms, the JPEG fixtures)
   read in colour and in grey must give OpenCV's digest; a seeded tree of
   512 x 512 WHU-style TIFF tiles and masks (uncompressed and PackBits)
   goes through ``tools.rsprompter.whu2coco`` (its JSON's sha256 must be
   the JAX tool's, ``WHU_JSON_SHA256``), ``tools.misc.print_config``,
   ``tools.train`` on ``rsprompter_anchor-whu.py`` at full width through
   ``tools/slurm_train.sh`` in a faked one-node SLURM job (6 steps), and
   ``tools.test`` on its checkpoint (every test tile evaluated,
   ``coco/segm_mAP`` printed); each rank runs ``tools.train``'s main through
   a wrapper (``TRAIN_MODULE``) that writes its launch counts, and
   ``tools.test``'s are counted here: A, B and C a forward, no backward
   kernel. Prints the host ms of a TIFF decode by compression and of
   ``whu2coco`` a tile, train s an iteration and test images/s.

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
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor-core rate: one pass
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = 2e-2  # max |kernel - plain| relative to max |plain| (bf16 inputs)
# the same for one fp32 kernel (3xTF32 keeps about fp32's accuracy; one TF32
# pass would read about 1e-3)
F32_TOL = 1e-4


PYCACHE = os.path.join(ROOT, "build", "pycache")


def enable_bytecode_cache() -> None:
    """Let this process and the ones it starts (the tools, torchrun's ranks)
    keep compiled bytecode in ``build/pycache`` of the checkout. Where the
    environment forbids writing it (``PYTHONDONTWRITEBYTECODE``, as on the
    card's machine), every process compiles torch anew on import: about 17
    s for ``import torch, torch._dynamo`` there, about 9 s with the cache."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref, tol: float = TOL) -> float:
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if err > tol * scale:
        raise AssertionError(
            f"{name}: max |kernel - plain| = {err:.4g} exceeds {tol} x {scale:.4g}"
        )
    return err


def operand_terms(dtype) -> dict:
    """What a kernel row at operand ``dtype`` (bf16, or fp32 on the 3xTF32
    variants) is held to and timed with: its tolerance, the peak rate of its
    bound (one TF32 pass for fp32; 3xTF32 makes three), its variant and
    source suffixes, and its timer (fewer runs for the slow fp32 plain
    versions, to keep phase 20 short)."""
    import torch

    if dtype == torch.float32:
        return dict(tol=F32_TOL, peak=PEAK_TF32_FLOPS, suffix="/f32", src="_f32", name="fp32",
                    ms=lambda fn: cuda_time_ms(fn, warmup=2, iters=5, repeat=3))
    if dtype != torch.bfloat16:
        raise ValueError(f"kernel rows take bf16 or fp32 operands, not {dtype}")
    return dict(tol=TOL, peak=PEAK_BF16_FLOPS, suffix="", src="", name="bf16", ms=cuda_time_ms)


def compare_as(name: str, got, ref, dtype, tol: float) -> float:
    """``compare``, and the kernel's output must keep its operands' dtype."""
    if got.dtype != dtype:
        raise AssertionError(f"{name}: kernel output {got.dtype} from {dtype} operands")
    return compare(name, got, ref, tol)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# the TPU kernels that A, B and C replace (at head dim 80, JAX runs XLA
# attention and its own qkv projection: those rows generalise the hd-64 kernels)
REPLACES = {
    "mlp": "rsprompter_tpu/ops/fused_mlp.py:54",
    "qkv/global": "rsprompter_tpu/ops/fused_mlp.py:143",
    "qkv/window": "rsprompter_tpu/ops/fused_mlp.py:604",
    "attention/global": "rsprompter_tpu/ops/fused_vit_attention.py:472",
    "attention/window": "rsprompter_tpu/ops/fused_vit_attention.py:421",
}


HD80_NOTE = " (no TPU kernel at head dim 80: JAX runs XLA)"


def _replaces(key: str, d: int = 64) -> str:
    return REPLACES[key] + ("" if d == 64 else HD80_NOTE)


def mlp_row(rnd, dev, t: int, c: int, tag: str = "", launches_alone: bool = False,
            inputs=None) -> dict:
    """Kernel A at x (t, c), M = 4 c, against its plain version, with the
    kernel, plain, composed-library and bound times, at the dtype ``rnd``
    draws in (bf16, or fp32 for the 3xTF32 variant); ``launches_alone`` also
    logs its three launches' times. ``inputs`` = (x, ln_w, ln_b, w1, b1, w2,
    b2, eps), as a layer of the path gives them, replace the random ones."""
    import torch

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    mlp = 4 * c
    args = inputs or (
        rnd(t, c), 1 + rnd(c, scale=0.1, dtype=torch.float32),
        rnd(c, scale=0.1, dtype=torch.float32), rnd(mlp, c, scale=0.02), rnd(mlp, scale=0.02),
        rnd(c, mlp, scale=0.02), rnd(c, scale=0.02), 1e-6)
    x, ln_w, ln_b, w1, b1, w2, b2, eps = args
    (t, c), mlp, dev, es = x.shape, w1.shape[0], x.device, x.element_size()
    op = operand_terms(x.dtype)
    got = fm.ln_mlp_residual(*args)
    torch.cuda.synchronize()
    ref = fm.ln_mlp_residual_plain(*[a.float() if torch.is_tensor(a) else a for a in args])
    err = compare_as(f"ln_mlp_residual{op['suffix']}{tag}", got, ref, x.dtype, op["tol"])
    flops = 4.0 * t * c * mlp
    nbytes = 2 * t * c * es + 2 * c * mlp * es + (mlp + c) * es + 2 * c * 4
    b_ms, b_by = bound_ms(flops, nbytes, op["peak"])
    if launches_alone:  # the row pass, fc1 + GELU, fc2 + residual
        z, hid, out = torch.empty_like(x), torch.empty((t, mlp), dtype=x.dtype, device=dev), \
            torch.empty_like(x)
        parts = {
            "row pass": lambda: fm.LN_ROWS.launch(fm.ptr(x), fm.ptr(ln_w), fm.ptr(ln_b),
                                                  fm.ptr(z), 1, 1, t, c, 0, eps,
                                                  variant="check"),
            "fc1": lambda: fm.LN_MLP_RESIDUAL.launch(fm.ptr(z), fm.ptr(w1), fm.ptr(b1),
                                                     fm._NULL, fm.ptr(hid), t, mlp, c, 0,
                                                     variant="check"),
            "fc2": lambda: fm.LN_MLP_RESIDUAL.launch(fm.ptr(hid), fm.ptr(w2), fm.ptr(b2),
                                                     fm.ptr(x), fm.ptr(out), t, c, mlp, 1,
                                                     variant="check"),
        }
        log("kernel A's launches alone (ms): " + ", ".join(
            f"{k} {cuda_time_ms(f):.4f}" for k, f in parts.items()))
        del z, hid, out
    ln_wb, ln_bb = ln_w.to(x.dtype), ln_b.to(x.dtype)
    F = torch.nn.functional

    def library_a():  # composed of PyTorch calls: LN -> fc1 -> exact GELU -> fc2 + residual
        z = F.layer_norm(x, (c,), ln_wb, ln_bb, eps)
        return x + F.linear(F.gelu(F.linear(z, w1, b1), approximate="none"), w2, b2)

    torch.testing.assert_close(library_a().float(), ref,
                               atol=op["tol"] * ref.abs().max().item(), rtol=0)
    return dict(
        name=f"ln_mlp_residual{op['suffix']}{tag}", kernel=fm.LN_MLP_RESIDUAL,
        variant="fc1" + op["suffix"], route="cuda",
        source=f"rsprompter_tpu_torch/csrc/ln_mlp_residual{op['src']}.cu",
        replaces=_replaces("mlp"),
        shape=f"x ({t}, {c}) {op['name']}, W1 {c}x{mlp}, W2 {mlp}x{c}",
        max_abs_err=err,
        ms=op["ms"](lambda: fm.ln_mlp_residual(*args)),
        plain_ms=op["ms"](lambda: fm.ln_mlp_residual_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=op["ms"](library_a),
    )


def qkv_rows(rnd, dev, bsz: int, grid: int, c: int, heads: int, win: int,
             tag: str = "", inputs=None, variants=("global", "window")) -> list:
    """Kernel B's row pass alone and kernel B (row pass + GEMM) on x (bsz,
    grid, grid, c) with ``heads`` heads of c / heads, global and windowed
    (``variants``), each against its plain version, at the dtype ``rnd``
    draws in (bf16, or fp32 for the 3xTF32 variants). ``inputs`` = (x, ln_w,
    ln_b, wq, bq, eps), as a layer of the path gives them, replace the random
    ones."""
    import torch

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    F = torch.nn.functional
    rows = []
    xg, ln_w, ln_b, wq, bq, eps = inputs or (
        rnd(bsz, grid, grid, c), 1 + rnd(c, scale=0.1, dtype=torch.float32),
        rnd(c, scale=0.1, dtype=torch.float32), rnd(3 * c, c, scale=0.02),
        rnd(3 * c, scale=0.02), 1e-6)
    (bsz, grid, _, c), dev, dt, es = xg.shape, xg.device, xg.dtype, xg.element_size()
    op, sfx = operand_terms(dt), operand_terms(dt)["suffix"]
    source = f"rsprompter_tpu_torch/csrc/ln_qkv_headmajor{op['src']}.cu"
    d = c // heads
    t = bsz * grid * grid  # the real tokens: a window's zero pad takes no products
    ln_wb, ln_bb = ln_w.to(dt), ln_b.to(dt)
    for variant, window in (("global", 0), ("window", win)):
        if variant not in variants:
            continue
        replaces = _replaces(f"qkv/{variant}", d)
        # the row pass alone (LN, window partition, zero pad into z)
        n_img, s = fm._qkv_rows(xg, 3 * heads, window)
        z = torch.empty((n_img * s, c), dtype=dt, device=dev)

        def row_pass(z=z, window=window):
            fm.LN_ROWS.launch(fm.ptr(xg), fm.ptr(ln_w), fm.ptr(ln_b), fm.ptr(z), bsz, grid,
                              grid, c, window, eps, variant="check",
                              f32=dt == torch.float32)

        row_pass()
        torch.cuda.synchronize()
        err = compare(f"ln_rows/{variant}{sfx}{tag}", z,
                      fm.ln_rows_plain(xg.float(), ln_w, ln_b, window, eps), op["tol"])
        b_ms, b_by = bound_ms(0.0, xg.numel() * es + z.numel() * es + 2 * c * 4, op["peak"])
        rows.append(dict(
            name=f"ln_rows/{variant}{sfx}{tag}", kernel=fm.LN_ROWS, variant=variant + sfx,
            route="cuda", source=source, replaces=replaces,
            shape=f"x ({bsz}, {grid}, {grid}, {c}) -> z {tuple(z.shape)} {op['name']}",
            max_abs_err=err, ms=op["ms"](row_pass),
            plain_ms=op["ms"](lambda window=window: fm.ln_rows_plain(
                xg, ln_w, ln_b, window, eps)),
            bound_ms=b_ms, bound_by=b_by,
            # global: one call (LN); window: LN, then the partition and pad
            library_ms=op["ms"](lambda window=window: fm.window_partition(
                F.layer_norm(xg, (c,), ln_wb, ln_bb, eps), window).contiguous()),
        ))
        del z
        a = (xg, ln_w, ln_b, wq, bq, 3 * heads, window, eps)
        got = fm.ln_qkv_headmajor(*a)
        torch.cuda.synchronize()
        ref = fm.ln_qkv_headmajor_plain(*[v.float() if torch.is_tensor(v) else v for v in a])
        err = compare_as(f"ln_qkv_headmajor/{variant}{sfx}{tag}", got, ref, dt, op["tol"])

        def library_b(window=window, shape=got.shape):
            # composed of PyTorch calls: LN -> window partition and zero
            # pad (window layers) -> qkv -> head-major copy
            z = fm.window_partition(F.layer_norm(xg, (c,), ln_wb, ln_bb, eps), window)
            return F.linear(z, wq, bq).reshape(shape[0], shape[2], shape[1], d).permute(
                0, 2, 1, 3).contiguous()

        torch.testing.assert_close(library_b().float(), ref,
                                   atol=op["tol"] * ref.abs().max().item(), rtol=0)
        flops = 2.0 * t * c * 3 * c
        nbytes = t * c * es + 3 * c * c * es + 3 * c * es + 2 * c * 4 + got.numel() * es
        b_ms, b_by = bound_ms(flops, nbytes, op["peak"])
        rows.append(dict(
            name=f"ln_qkv_headmajor/{variant}{sfx}{tag}", kernel=fm.LN_QKV_HEADMAJOR,
            variant=variant + sfx, route="cuda", source=source, replaces=replaces,
            shape=f"x ({bsz}, {grid}, {grid}, {c}) -> {tuple(got.shape)} {op['name']}",
            max_abs_err=err,
            ms=op["ms"](lambda: fm.ln_qkv_headmajor(*a)),
            plain_ms=op["ms"](lambda: fm.ln_qkv_headmajor_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=op["ms"](library_b),
        ))
        del got, ref
    return rows


def attention_rows(rnd, bsz: int, grid: int, heads: int, d: int, win: int,
                   tag: str = "", inputs=None, variants=("global", "window")) -> list:
    """Kernel C on qkv of ``heads`` heads of ``d``, at the global grid and
    the windows of a batch of ``bsz`` (``variants``), against its plain
    version, at the dtype ``rnd`` draws in (bf16, or fp32 for the 3xTF32
    variant); the library call is SDPA with the bias materialised in qkv's
    dtype.
    ``inputs`` = (qkv, fh, fw), as a layer of the path gives them to the one
    variant asked for, replace the random ones."""
    import torch

    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    rows = []
    n_win = bsz * (-(-grid // win)) ** 2
    for variant, n_img, hw in (("global", bsz, (grid, grid)), ("window", n_win, (win, win))):
        if variant not in variants:
            continue
        s = hw[0] * hw[1]
        qkv, fh, fw = inputs or (rnd(n_img, 3 * heads, s, d),
                                 rnd(n_img, heads, s, hw[0], scale=0.5),
                                 rnd(n_img, heads, s, hw[1], scale=0.5))
        n_img, op, es = qkv.shape[0], operand_terms(qkv.dtype), qkv.element_size()
        sfx = op["suffix"]
        got = fa.relpos_attention(qkv, fh, fw, hw)
        torch.cuda.synchronize()
        ref = fa.relpos_attention_plain(qkv.float(), fh.float(), fw.float(), hw)
        err = compare_as(f"relpos_attention/{variant}{sfx}{tag}", got, ref, qkv.dtype,
                         op["tol"])
        del ref
        q, k, v = qkv[:, :heads], qkv[:, heads : 2 * heads], qkv[:, 2 * heads :]
        bias = (fh[..., :, None] + fw[..., None, :]).reshape(n_img, heads, s, s)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = op["ms"](lambda: sdpa(q, k, v, attn_mask=bias))
        del bias
        flops = 4.0 * n_img * heads * s * s * d
        nbytes = (qkv.numel() + fh.numel() + fw.numel() + got.numel()) * es
        b_ms, b_by = bound_ms(flops, nbytes, op["peak"])
        # the fp32 variant has one path for every grid
        route = "one" if sfx else fa.relpos_attention_route(hw, d)
        rows.append(dict(
            name=f"relpos_attention/{variant}{sfx}{tag}", kernel=fa.RELPOS_ATTENTION,
            variant=variant + sfx, route="cuda",
            source=f"rsprompter_tpu_torch/csrc/relpos_attention{op['src']}.cu",
            replaces=_replaces(f"attention/{variant}", d),
            shape=f"qkv {tuple(qkv.shape)} {op['name']}, factors h={hw[0]} w={hw[1]}, "
                  f"{route} path",
            max_abs_err=err,
            ms=op["ms"](lambda: fa.relpos_attention(qkv, fh, fw, hw)),
            plain_ms=op["ms"](lambda: fa.relpos_attention_plain(qkv, fh, fw, hw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))
        del got
    return rows


def log_rows(rows, what: str = "max|plain|", tol: float = TOL) -> None:
    for r in rows:
        log(f"kernel {r['name']}: {r['shape']}; max_abs_err {r['max_abs_err']:.4g} "
            f"(tol {tol} x {what}); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")


def k12_row(name: str, x, w, b, heads3: int, n_img: int, variant: str, path: str,
            adapter=None) -> dict:
    """K12' on flat tokens ``x`` (n_img windows or images) against its plain
    version, or with ``adapter`` = (la, lb, scale) K12' with the LoRA
    adapter folded into its K; the library call composed of PyTorch calls in
    x's dtype (bf16, or fp32 for the 3xTF32 variant: SGEMM, TF32 off).
    Returns its kernel row."""
    import torch

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    F = torch.nn.functional
    a = (x, w, b) + (tuple(adapter) if adapter else ()) + (heads3, n_img)
    fn = fm.qkv_headmajor_lora if adapter else fm.qkv_headmajor
    plain = fm.qkv_headmajor_lora_plain if adapter else fm.qkv_headmajor_plain
    op, es = operand_terms(x.dtype), x.element_size()
    got = fn(*a)
    torch.cuda.synchronize()
    err = compare_as(name, got, plain(*[v.float() if torch.is_tensor(v) else v for v in a]),
                     x.dtype, op["tol"])
    d = w.shape[0] // heads3

    def library():
        y = F.linear(x, w, b)
        if adapter:
            la, lb, scale = adapter
            y = y + ((x @ la) @ lb) * scale
        return y.reshape(n_img, -1, heads3, d).permute(0, 2, 1, 3).contiguous()

    m, c, k = x.shape[0], x.shape[1], w.shape[0]
    flops, nbytes = 2.0 * m * c * k, (x.numel() + w.numel() + b.numel() + got.numel()) * es
    if adapter:
        r = adapter[0].shape[1]
        flops += 2.0 * m * r * (c + k)
        nbytes += (adapter[0].numel() + adapter[1].numel()) * es
    b_ms, b_by = bound_ms(flops, nbytes, op["peak"])
    return dict(
        name=name, kernel=fm.QKV_HEADMAJOR, variant=variant + op["suffix"], route="cuda",
        source=f"rsprompter_tpu_torch/csrc/ln_qkv_headmajor{op['src']}.cu",
        replaces="rsprompter_tpu/ops/fused_mlp.py:154" + ("" if d == 64 else HD80_NOTE),
        path=path, shape=f"x {tuple(x.shape)}" + (f" + adapter r {r}" if adapter else "")
        + f" -> {tuple(got.shape)} {op['name']}", max_abs_err=err,
        ms=op["ms"](lambda: fn(*a)), plain_ms=op["ms"](lambda: plain(*a)),
        bound_ms=b_ms, bound_by=b_by, library_ms=op["ms"](library),
    )


# the TPU kernels that kernel C replaces on the 'flash' route (K10)
FLASH_REPLACES = {"global": "rsprompter_tpu/ops/flash_attention.py:37",
                  "window": "rsprompter_tpu/ops/flash_attention.py:101"}
ODD_HEADS_REPLACES = "rsprompter_tpu/ops/fused_vit_attention.py:254"  # K11


def kernel_phase(dev):
    import torch

    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    g = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bsz, grid, c, heads, win = 2, 64, 768, 12, 14
    t = bsz * grid * grid
    rows = [mlp_row(rnd, dev, t, c, launches_alone=True)]
    rows += qkv_rows(rnd, dev, bsz, grid, c, heads, win)
    rows += attention_rows(rnd, bsz, grid, heads, 64, win)
    # K12' below reuses kernel B's weights
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)

    # --- K10': kernel C on the 'flash' route, at K3's and K5's shapes --------
    for r in [r for r in rows if r["kernel"] is fa.RELPOS_ATTENTION]:
        rows.append(dict(r, name=f"relpos_attention/flash-{r['variant']}",
                         replaces=FLASH_REPLACES[r["variant"]], path="query_flash"))

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
        replaces=ODD_HEADS_REPLACES, path=None,
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
        rows.append(k12_row(f"qkv_headmajor/{variant}", rnd(n_img * s, c), wq, bq, 3 * heads,
                            n_img, variant, "query_flash"))
    for r in rows:
        r.setdefault("path", "anchor_predict")
    log_rows(rows)
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


def expected_forward_launches(det, forwards: int) -> dict:
    """Kernels A, B and C over ``forwards`` encoder forwards, as phase 3
    counts one."""
    depth = det.backbone.config.num_hidden_layers
    n_global = len(det.backbone.config.global_attn_indexes)
    per_kind = {"global": n_global * forwards, "window": (depth - n_global) * forwards}
    return {"ln_mlp_residual": mlp_launches(depth * forwards),
            "ln_rows": dict(per_kind, mlp=depth * forwards),
            "ln_qkv_headmajor": per_kind, "relpos_attention": per_kind, "qkv_headmajor": {}}


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

    for name, want in expected_forward_launches(det, iters).items():
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


def backward_kernel_phase(dev, bsz: int = 4, grid: int = 32,
                          kinds=("A'", "B'", "C'", "K12'"), path: str = "train_step"):
    """Phase 4 at the anchor train step's shapes (ViT-B 512^2, batch 4); with
    ``bsz``, ``grid`` and ``kinds`` the same checks of the named backward
    kernels at another path's shapes (phase 14: A' and C' at 1024^2, batch
    2). Returns the kernel rows, each marked with ``path``."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(1)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def f32(args):
        return [a.float() if torch.is_tensor(a) else a for a in args]

    rows = []
    c, heads, mlp, win = 768, 12, 3072, 14
    t = bsz * grid * grid
    n_win = bsz * (-(-grid // win)) ** 2  # windows of the padded grid
    ln_w = 1 + rnd(c, scale=0.1, dtype=torch.float32)
    ln_b = rnd(c, scale=0.1, dtype=torch.float32)

    if "A'" in kinds:
        rows.append(a_prime_row(rnd, f32, t, c, mlp, ln_w, ln_b))
    if "B'" in kinds:
        rows += b_prime_rows(rnd, f32, bsz, grid, c, heads, win, n_win, ln_w, ln_b)
    if "C'" in kinds:
        rows += c_prime_rows(rnd, bsz, grid, heads, win, n_win)
    if "K12'" in kinds:
        k12_backward_check(rnd, c, heads, win, n_win)
    for r in rows:
        r["path"] = path
    log_rows(rows, "max|plain| per output")
    return rows


def a_prime_row(rnd, f32, t, c, mlp, ln_w, ln_b, tag: str = "") -> dict:
    """A' against its fp32 plain version at ``t`` rows; a second launch must
    give the same bits. Returns its kernel row (named with ``tag``)."""
    import torch
    import torch.nn.functional as F

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    args = (rnd(t, c), ln_w, ln_b, rnd(mlp, c, scale=0.02), rnd(mlp, scale=0.02),
            rnd(c, mlp, scale=0.02), rnd(c, scale=0.02), rnd(t, c))
    got = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    name = f"ln_mlp_residual_bwd{tag}"
    err = compare_each(name, got, fm.ln_mlp_residual_bwd_plain(*f32(args), 1e-6))
    again = fm.ln_mlp_residual_bwd(*args, 1e-6)
    torch.cuda.synchronize()
    for what, x, y in zip(("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), got, again):
        if not torch.equal(x, y):
            raise AssertionError(
                f"{name}: a second launch changed {what} "
                f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
    log(f"{name}: a second launch gives the same bits in all seven outputs")
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
    return dict(
        name=name, kernel=fm.LN_MLP_RESIDUAL_BWD, variant="",
        route="cuda", source="rsprompter_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
        replaces="rsprompter_tpu/ops/fused_mlp.py:483",
        shape=f"x, dO ({t}, {c}) bf16, W1 {mlp}x{c}, W2 {c}x{mlp}", max_abs_err=err,
        ms=cuda_time_ms(lambda: fm.ln_mlp_residual_bwd(*args, 1e-6)),
        plain_ms=cuda_time_ms(lambda: fm.ln_mlp_residual_bwd_plain(*args, 1e-6)),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )


def b_prime_rows(rnd, f32, bsz, grid, c, heads, win, n_win, ln_w, ln_b,
                 tag: str = "") -> list:
    """B' (global and window) with ``heads`` heads of c / heads against its
    fp32 plain version; a second launch must give the same bits. Returns
    its kernel rows (named with ``tag``)."""
    import torch
    import torch.nn.functional as F

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    rows = []
    t = bsz * grid * grid
    d = c // heads
    xg = rnd(bsz, grid, grid, c)
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    for variant, window, replaces in (
        ("global", 0, "rsprompter_tpu/ops/fused_mlp.py:334"),
        ("window", win, "rsprompter_tpu/ops/fused_mlp.py:707"),
    ):
        n_img, s = (bsz, grid * grid) if not window else (n_win, win * win)
        name = f"ln_qkv_headmajor_bwd/{variant}{tag}"
        dy = rnd(n_img, 3 * heads, s, d)
        a = (xg, ln_w, ln_b, wq, bq, dy, 3 * heads, window, 1e-6)
        got = fm.ln_qkv_headmajor_bwd(*a)
        torch.cuda.synchronize()
        err = compare_each(name, got, fm.ln_qkv_headmajor_bwd_plain(*f32(a)))
        again = fm.ln_qkv_headmajor_bwd(*a)
        torch.cuda.synchronize()
        for what, x, y in zip(("dx", "dgamma", "dbeta", "dW", "db"), got, again):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{name}: a second launch changed {what} "
                    f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
        log(f"{name}: a second launch gives the same bits in all five outputs")
        del got, again
        library_ms = composed_backward_ms(  # LN -> window partition -> qkv -> head-major
            lambda x, lw, lb, w, b, window=window, n_img=n_img, s=s: F.linear(
                fm.window_partition(F.layer_norm(x, (c,), lw, lb, 1e-6), window), w, b
            ).reshape(n_img, s, 3 * heads, d).permute(0, 2, 1, 3),
            (xg, ln_w, ln_b, wq, bq), dy)
        # dW and dz over the t real tokens: window pad rows have z = 0 and feed
        # no token; only db reads their dy, a sum counted in the bytes
        flops = 2 * 2.0 * t * c * 3 * c
        nbytes = (2 * t * c * 2 + dy.numel() * 2 + 2 * 3 * c * c * 2 + 2 * 3 * c * 2
                  + 4 * c * 4)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=name, kernel=fm.LN_QKV_HEADMAJOR_BWD,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor_bwd.cu",
            replaces=replaces + ("" if d == 64 else HD80_NOTE),
            shape=f"x ({bsz}, {grid}, {grid}, {c}), dy {tuple(dy.shape)} bf16",
            max_abs_err=err, ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor_bwd(*a)),
            plain_ms=cuda_time_ms(lambda: fm.ln_qkv_headmajor_bwd_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))
    return rows


def c_prime_rows(rnd, bsz, grid, heads, win, n_win, d: int = 64, tag: str = "") -> list:
    """C' (global and window) at ``heads`` heads of ``d`` against its fp32
    plain version; a second launch must give the same bits. Returns its
    kernel rows (named with ``tag``)."""
    import torch

    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    rows = []
    for variant, n_img, hw, replaces in (
        ("global", bsz, (grid, grid), "rsprompter_tpu/ops/fused_vit_attention.py:779"),
        ("window", n_win, (win, win), "rsprompter_tpu/ops/fused_vit_attention.py:752"),
    ):
        s = hw[0] * hw[1]
        name = f"relpos_attention_bwd/{variant}{tag}"
        qkv = rnd(n_img, 3 * heads, s, d)
        fh = rnd(n_img, heads, s, hw[0], scale=0.5)
        fw = rnd(n_img, heads, s, hw[1], scale=0.5)
        dout = rnd(n_img, heads, s, d)
        out, lse = fa._relpos_attention_fwd(qkv, fh, fw, hw, True)
        a = (qkv, fh, fw, out, lse, dout, hw)
        got = fa.relpos_attention_bwd(*a)
        torch.cuda.synchronize()
        err = compare_each(name, got, fa.relpos_attention_bwd_plain(
            qkv.float(), fh.float(), fw.float(), dout.float(), hw))
        again = fa.relpos_attention_bwd(*a)
        torch.cuda.synchronize()
        for what, x, y in zip(("dqkv", "dfh", "dfw"), got, again):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{name}: a second launch changed {what} "
                    f"(max |diff| {(x.float() - y.float()).abs().max().item():.4g})")
        log(f"{name}: a second launch gives the same bits in dqkv, dfh and dfw")
        del again
        q, k, v = qkv[:, :heads], qkv[:, heads : 2 * heads], qkv[:, 2 * heads :]
        bias = (fh[..., :, None] + fw[..., None, :]).reshape(n_img, heads, s, s)
        library_ms = sdpa_backward_ms(q, k, v, bias, dout)
        del bias
        flops = 5 * 2.0 * n_img * heads * s * s * d  # q k^T again, dP, dV, dQ, dK
        nbytes = ((qkv.numel() + fh.numel() + fw.numel() + out.numel() + dout.numel()) * 2
                  + lse.numel() * 4 + (qkv.numel() + fh.numel() + fw.numel()) * 2)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            name=name, kernel=fa.RELPOS_ATTENTION_BWD,
            variant=variant, route="cuda",
            source="rsprompter_tpu_torch/csrc/relpos_attention_bwd.cu",
            replaces=replaces + ("" if d == 64 else HD80_NOTE),
            shape=f"qkv {tuple(qkv.shape)} bf16, factors h={hw[0]} w={hw[1]}",
            max_abs_err=err, ms=cuda_time_ms(lambda: fa.relpos_attention_bwd(*a)),
            plain_ms=cuda_time_ms(lambda: fa.relpos_attention_bwd_plain(
                qkv, fh, fw, dout, hw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        ))
    return rows


def k12_backward_check(rnd, c, heads, win, n_win) -> None:
    """K12''s backward (torch products, as JAX leaves it to XLA) through the
    kernel's Function on the card, at the windowed shape, against plain
    autograd."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm

    s = win * win
    leaves = [t.requires_grad_(True) for t in (rnd(n_win * s, c), rnd(3 * c, c, scale=0.02),
                                               rnd(3 * c, scale=0.02))]
    dy = rnd(n_win, 3 * heads, s, 64)
    fm.qkv_headmajor(*leaves, 3 * heads, n_win).backward(dy)
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    fm.qkv_headmajor_plain(*ref, 3 * heads, n_win).backward(dy.float())
    err = compare_each("qkv_headmajor backward", [t.grad for t in leaves],
                       [t.grad for t in ref])
    log(f"K12' backward through the kernel's Function vs plain autograd: max_abs_err "
        f"{err:.4g} (tol {TOL} x max|plain| per gradient)")


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
# The query steps' check (frozen encoder) takes its ratios at this many
# trained states, this many steps apart, and holds their median: one state's
# ratio compares two bf16 error samples through that state's head, which its
# draws hardly change. With kernels as accurate as plain bf16 at the encoder's
# output, one state's median-tensor ratio went over FLOOR_FACTOR at 1 of 60
# states of the query step and 4 of 42 with decoder_plus=False; the median of
# 7 consecutive states at none of 72, the largest 1.467
# (scripts/torch_query_grad_check.py; PERF.md section 6)
QUERY_GRAD_STATES = 7
QUERY_GRAD_GAP = 3
# the loss never reaches the IoU head (RSPrompter trains no IoU target); JAX
# gives it zero gradients, the port none
UNREACHED = "roi_head.mask_head.mask_decoder.iou_prediction_head."
UNREACHED_QUERY = "panoptic_head.mask_decoder.iou_prediction_head."


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


def check_train_launches(what: str, counts, model, steps: int, lora: bool = False) -> None:
    """Every encoder layer through A, B, C forward and A', B', C' backward
    in each of ``steps`` train steps, K12' never; with ``lora`` (the LoRA
    route) K12' in B's place and B, B' never."""
    depth = model.backbone.config.num_hidden_layers
    n_global = len(model.backbone.config.global_attn_indexes)
    per_kind = {"global": n_global * steps, "window": (depth - n_global) * steps}
    expect = {
        "ln_mlp_residual": mlp_launches(depth * steps),
        "ln_rows": dict(per_kind, mlp=depth * steps), "ln_qkv_headmajor": per_kind,
        "relpos_attention": per_kind, "ln_mlp_residual_bwd": {"": depth * steps},
        "ln_qkv_headmajor_bwd": per_kind, "relpos_attention_bwd": per_kind,
        "qkv_headmajor": {},
    }
    if lora:
        expect.update(ln_rows={"mlp": depth * steps}, ln_qkv_headmajor={},
                      ln_qkv_headmajor_bwd={}, qkv_headmajor=per_kind)
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"{what}: {name} launches {counts[name]}, expected {want}")


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

    check_train_launches("train", counts, model, iters)
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
        f"{len(rel)} tensors; rel-pos tables worst "
        f"{f'{max(tables):.4g}' if tables else 'none (frozen)'}; next worst: "
        + ", ".join(f"{n} {rel[n]:.4g}"
                    for n in sorted(rel, key=rel.get, reverse=True)[1:6]))
    if tol is not None and rel[worst] > tol:
        raise AssertionError(f"gradient check, {what}: {worst} {rel[worst]:.4g} > {tol}")


def check_floor(what: str, got_rel, floor_rel) -> None:
    """Phase 6's rule: the kernels' distance from the reference at most
    ``FLOOR_FACTOR`` times the plain bf16 run's, at the median tensor and at
    the worst."""
    for name, stat in (("median", statistics.median), ("worst", max)):
        got, base = stat(got_rel.values()), stat(floor_rel.values())
        msg = (f"gradient check, {what}, {name} tensor: kernels {got:.4g} from the "
               f"reference, plain bf16 {base:.4g}; ratio {got / base:.4g} "
               f"(limit {FLOOR_FACTOR})")
        log(msg)
        if got > FLOOR_FACTOR * base:
            raise AssertionError(msg)


class CutLossRuns:
    """Phase 6's runs of one batch's whole loss, ``loss_fn()``, with the
    encoder's outputs cut into bf16 leaves (the fp32 encoder's rounded as
    the others' are, before the neck and heads read them) and the encoder's
    gradients taken apart, from those leaves' cotangents. The caller holds
    the proposals (phase 6's reason: on random weights the RPN's top-k is
    full of near-ties that bf16 noise reorders, and the runs would
    otherwise sample different RoIs)."""

    def __init__(self, model, opt, loss_fn, enc_trains: bool = True):
        self.model, self.opt, self.loss_fn = model, opt, loss_fn
        self.enc, self.enc_trains = model.backbone, enc_trains
        self.seen = {}

    def _cut(self, mod, inputs, outputs):
        import torch

        leaves = [t.detach().to(torch.bfloat16).requires_grad_(True)
                  for t in (outputs[0],) + tuple(outputs[1])]
        self.seen["images"], self.seen["leaves"] = inputs[0].detach(), leaves
        return leaves[0], tuple(leaves[1:])

    def encoder_grads(self, impl: str, cot) -> dict:
        """The encoder's parameter gradients on the last run's images, given
        the cotangents ``cot`` of its outputs."""
        import torch

        if not self.enc_trains:
            return {}
        enc = self.enc
        enc.impl = impl
        enc.zero_grad(set_to_none=True)
        neck, hidden = enc(self.seen["images"])
        outs = (neck,) + tuple(hidden)
        torch.autograd.backward(outs, [c.to(o.dtype) for c, o in zip(cot, outs)])
        return {f"backbone.{n}": p.grad.float().clone() for n, p in enc.named_parameters()}

    def whole_loss_grads(self, impl: str):
        """Every parameter's gradient through the encoder's ``impl`` route,
        and the cotangents of the encoder's outputs."""
        import torch

        from rsprompter_tpu_torch.engine.train_state import total_loss

        self.enc.impl = impl
        self.opt.zero_grad()
        hook = self.enc.register_forward_hook(self._cut)
        try:
            total_loss(self.loss_fn()).backward()
        finally:
            hook.remove()
        cot = [t.grad if t.grad is not None else torch.zeros_like(t)
               for t in self.seen["leaves"]]
        grads = {n: p.grad.float().clone() for n, p in self.model.named_parameters()
                 if p.grad is not None}
        return {**grads, **self.encoder_grads(impl, cot)}, cot

    def noise_floor(self, cot=None, ref_cot: bool = False):
        """The bf16 noise floor's two runs: the plain versions in bf16
        (``plain``) and with the encoder computing in fp32 (``ref``, the
        reference). With ``cot``, also the encoder alone given those
        cotangents, in bf16 (``same_cot``) and, with ``ref_cot``, in fp32.
        Returns (plain, ref, same_cot, ref_cot)."""
        import torch

        from rsprompter_tpu_torch.apis.build import set_compute_dtype

        try:
            plain, _ = self.whole_loss_grads("plain")
            same = self.encoder_grads("plain", cot) if cot is not None else {}
            set_compute_dtype(self.enc, torch.float32, cast_params=False)
            ref, _ = self.whole_loss_grads("plain")
            ref_same = self.encoder_grads("plain", cot) if ref_cot else None
        finally:
            set_compute_dtype(self.enc, torch.bfloat16, cast_params=False)
            self.enc.impl = "kernel"
        return plain, ref, same, ref_same


def gradient_phase(model, opt, loss_fn, only=None, encoder_floor: bool = False):
    """Phase 6 (and phase 12's, ``only`` naming the parameters compared:
    those that train). ``loss_fn()`` runs one batch with fixed draws through the
    whole loss three times (:class:`CutLossRuns`): through the kernels,
    through the plain versions, and through the plain versions with the
    encoder computing in fp32 (the reference). All three take the kernels'
    run's proposals. Every
    parameter's gradient is compared on its own, and the kernels' distance
    from the reference is held to ``FLOOR_FACTOR`` times the plain bf16
    run's. The encoder is also run through the kernels and the plain
    versions with the same cotangents of its outputs, those of the kernels'
    run: that comparison sees the backward kernels alone, without the heads'
    amplification, and is held to ``GRAD_TOL``; with ``only`` (phase 12:
    the LoRA adapters are the encoder's only trained tensors, and their
    low-rank gradients, sums over every token, carry more bf16 noise than
    ``GRAD_TOL`` was set by) it is held to the same floor rule against the
    fp32 encoder given those cotangents. ``encoder_floor`` (phase 16's ViT-L
    and ViT-H steps, 24 and 32 layers deep, where ``GRAD_TOL``, set at
    ViT-B's 12, is not the limit) holds the encoder alone to that floor rule
    too, and reports its kernels-vs-plain reading without a limit. Where
    ``only`` names no encoder tensor (phase 14's frozen SAM-seg encoder) the
    encoder has no gradient to compare, and that part is skipped."""
    from rsprompter_tpu_torch.models.dense_heads import rpn_head as rpn_mod

    enc_trains = only is None or any(n.startswith("backbone.") for n in only)
    runs = CutLossRuns(model, opt, loss_fn, enc_trains)
    rpn_predict, kept = rpn_mod.rpn_predict, []

    def keep_first(*a, **kw):
        if not kept:
            kept.append(rpn_predict(*a, **kw))
        return kept[0]

    rpn_mod.rpn_predict = keep_first
    try:
        kernel, cot = runs.whole_loss_grads("kernel")
        plain, ref, same_cot, ref_cot = runs.noise_floor(
            cot, ref_cot=only is not None or encoder_floor)
    finally:
        rpn_mod.rpn_predict = rpn_predict
    if only is not None:
        kernel, plain, ref, same_cot, ref_cot = ({n: g for n, g in d.items() if n in only}
                                                 for d in (kernel, plain, ref, same_cot, ref_cot))
    floor = relative_grad_diffs(plain, ref)
    kernel_ref = relative_grad_diffs(kernel, ref)
    check_grads("whole loss, plain bf16 vs fp32-encoder reference (the floor)", floor, None)
    check_grads("whole loss, kernels vs fp32-encoder reference", kernel_ref, None)
    check_floor("whole loss", kernel_ref, floor)
    if only is None:
        check_grads("encoder with the same cotangents, kernels vs plain",
                    relative_grad_diffs({n: kernel[n] for n in same_cot}, same_cot),
                    None if encoder_floor else GRAD_TOL)
    if enc_trains and (only is not None or encoder_floor):
        # the adapters' gradients, or a deep encoder's: phase 6's rule
        # against the fp32 encoder given the same cotangents
        kernel_cot = relative_grad_diffs({n: kernel[n] for n in ref_cot}, ref_cot)
        floor_cot = relative_grad_diffs(same_cot, ref_cot)
        check_grads("encoder with the same cotangents, plain bf16 vs fp32 (the floor)",
                    floor_cot, None)
        check_grads("encoder with the same cotangents, kernels vs fp32", kernel_cot, None)
        check_floor("encoder with the same cotangents", kernel_cot, floor_cot)
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
    when each of the stage's modules (their forwards) or ``(owner, name)``
    callables (wrapped for the duration) is entered and left, the intervals
    summed over the call (one may run several times); the median over
    ``iters`` calls. It counts the stream's gaps inside a stage (host launch
    time) too, so it is the stage's share of the call, not its busy time."""
    import torch

    events = {name: [] for name in stages}
    depth = dict.fromkeys(stages, 0)  # a stage's callables may call each other

    def enter(name):
        depth[name] += 1
        if depth[name] == 1:
            events[name].append([torch.cuda.Event(enable_timing=True)])
            events[name][-1][0].record()

    def leave(name):
        depth[name] -= 1
        if depth[name] == 0:
            events[name][-1].append(torch.cuda.Event(enable_timing=True))
            events[name][-1][1].record()

    hooks, wrapped = [], []
    for name, targets in stages.items():
        for t in targets:
            if isinstance(t, tuple):
                owner, attr = t
                fn = getattr(owner, attr)

                def call(*a, _fn=fn, _name=name, **kw):
                    enter(_name)
                    out = _fn(*a, **kw)
                    leave(_name)
                    return out

                wrapped.append((owner, attr, fn, attr in vars(owner)))
                setattr(owner, attr, call)
            else:
                hooks += [t.register_forward_pre_hook(lambda _m, _a, n=name: enter(n)),
                          t.register_forward_hook(lambda _m, _a, _o, n=name: leave(n))]
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
        for owner, attr, fn, own in wrapped:
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
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
        for name, want in expected_forward_launches(det, n_batches).items():
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
    digest = report["digest"]
    del det, report
    return dict(timing, metrics=metrics, digest=digest)


# ---------------------------------------------------------------------------
# phase 10: the RSPrompter-query train step
# ---------------------------------------------------------------------------

QUERY_TRAIN_STEPS_PER_EPOCH = 260  # NWPU's 520 training images at batch 2
QUERY_LOSS_TERMS = 35  # 5 terms for each of 7 head calls


def device_ms(row) -> float:
    """A profiler row's device time (inclusive), ms, in old and new torch."""
    t = getattr(row, "device_time_total", None)
    return (row.cuda_time_total if t is None else t) / 1e3


def host_counts(prof) -> dict:
    """Counts of the host's CUDA API calls (launches, copies, waits) in a profile."""
    keys = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaEventSynchronize")
    return {e.key: e.count for e in prof.key_averages() if e.key in keys}


def query_train_phase(kernels, iters: int, profile_dir: str = ""):
    """Phase 10. Returns the kernels' launch counts over the timed steps."""
    import torch

    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.models.dense_heads import mask2former_head as head_mod
    from rsprompter_tpu_torch.models.task_modules import hungarian
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    trainer = build_trainer(QUERY_CONFIG, device="cuda", seed=0,
                            steps_per_epoch=QUERY_TRAIN_STEPS_PER_EPOCH)
    model, opt, cfg = trainer.model, trainer.optimizer, trainer.cfg
    head, enc = model.panoptic_head, model.backbone
    bsz = cfg["train_dataloader"]["batch_size"]
    size = tuple(cfg["crop_size"])
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in synthetic_batch(
        bsz, size, cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    valid = batch["gt_valid"].cpu()
    gen = torch.Generator(device="cuda")

    # the matcher, timed on the host: the whole call (the wait for the
    # forward, the one copy to the host, scipy) and scipy's solve, whose
    # host output is recorded (no copy back from the card)
    matched, call_s, solve_s = [], [], []
    match_fn, lsa_fn = head_mod.hungarian_match_batched, hungarian._lsa_host_batched

    def timed_lsa(*a):
        t0 = time.perf_counter()
        out = lsa_fn(*a)
        solve_s.append(time.perf_counter() - t0)
        matched.append(torch.from_numpy(out))
        return out

    def recorded_match(cost, gt_valid):
        t0 = time.perf_counter()
        out = match_fn(cost, gt_valid)
        call_s.append(time.perf_counter() - t0)
        return out

    def check(metrics, when):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        terms = [k for k in metrics if "loss" in k and k != "loss"]
        if bad or len(terms) != QUERY_LOSS_TERMS:
            raise AssertionError(f"query train step {when}: non-finite {bad}, "
                                 f"{len(terms)} loss terms")
        return {k: float(v) for k, v in metrics.items()}

    head_mod.hungarian_match_batched, hungarian._lsa_host_batched = recorded_match, timed_lsa
    try:
        first = check(trainer.step(batch, gen.manual_seed(0)), "warm-up")
        torch.cuda.synchronize()
        enc_before = {n: p.detach().clone() for n, p in enc.named_parameters()}
        before = {n: p.detach().clone() for n, p in opt.trained}
        reached = set()
        for k in kernels:
            k.reset_counts()
        matched.clear(), call_s.clear(), solve_s.clear()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            metrics = trainer.step(batch, gen.manual_seed(1 + i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reached |= {n for n, p in opt.trained} - set(opt.unreached)
            if not all(n.startswith(UNREACHED_QUERY) for n in opt.unreached):
                raise AssertionError(f"query train step: no gradient reached {opt.unreached}")
            last = check(metrics, f"{i + 1}")
        counts = {k.name: dict(k.variant_launches) for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        head_mod.hungarian_match_batched, hungarian._lsa_host_batched = match_fn, lsa_fn

    for n, p in enc.named_parameters():
        if p.grad is not None or not torch.equal(p.detach(), enc_before[n]):
            raise AssertionError(f"query train step: the frozen encoder's {n} got a "
                                 "gradient or moved")
    for n, p in opt.trained:
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"query train step: {n} has no finite gradient")
        if n in reached and torch.equal(p.detach(), before[n]):
            raise AssertionError(f"query train step: {n} was not updated")
    if len(matched) != iters:
        raise AssertionError(f"query train step: {len(matched)} match solves in {iters} steps")
    for m in matched:  # (calls x B, G): -1 exactly at invalid GT, one-to-one per image
        if m.numel() != head.num_head_calls * valid.numel():
            raise AssertionError(f"query train step: matches of shape {tuple(m.shape)}")
        m = m.reshape(head.num_head_calls, *valid.shape)
        if not torch.equal(m == -1, ~valid.expand_as(m)):
            raise AssertionError(f"query train step: matches {m.tolist()} against valid "
                                 f"{valid.tolist()}")
        for row, v in zip(m.reshape(-1, m.shape[-1]), valid.repeat(m.shape[0], 1)):
            picked = row[v]
            if len(set(picked.tolist())) != len(picked) or picked.max() >= head.num_queries:
                raise AssertionError(f"query train step: matches {row.tolist()} not one-to-one")

    depth = enc.config.num_hidden_layers
    n_global = len(enc.config.global_attn_indexes)
    per_kind = {"global": n_global * iters, "window": (depth - n_global) * iters}
    expect = {
        "ln_mlp_residual": mlp_launches(depth * iters),
        "ln_rows": dict(per_kind, mlp=depth * iters), "ln_qkv_headmajor": per_kind,
        "relpos_attention": per_kind, "ln_mlp_residual_bwd": {},
        "ln_qkv_headmajor_bwd": {}, "relpos_attention_bwd": {}, "qkv_headmajor": {},
    }
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"query train: {name} launches {counts[name]}, expected {want}")
    med = statistics.median(times)
    unreached = sorted(n for n, _ in opt.trained if n not in reached)
    log(f"query train step launches over {iters} steps: "
        f"{ {n: c for n, c in counts.items() if c} }")
    log(f"query train step: RSPrompter-query, ViT-B {size[0]}x{size[1]}, batch {bsz}, "
        f"{head.num_queries} queries, {head.num_points} points, bf16 compute, fp32 master "
        f"weights, encoder frozen: {med:.4f} s/step median of {iters} (min {min(times):.4f}, "
        f"max {max(times):.4f}), {bsz / med:.3f} images/s; peak device memory "
        f"{peak_gb:.2f} GiB; {len(opt.trained)} trained / {len(opt.frozen)} frozen tensors; "
        f"not reached by the loss: {len(unreached)} ({UNREACHED_QUERY}*); valid GT per image "
        f"{valid.sum(1).tolist()}")
    log(f"query train step: Hungarian match, host ms per step (median of {iters}): whole call "
        f"{statistics.median(call_s) * 1e3:.3f} (waits for the forward, one copy to the "
        f"host), scipy solve of {head.num_head_calls * bsz} matrices "
        f"{statistics.median(solve_s) * 1e3:.3f}")
    log(f"query train step 1 (warm-up): {json.dumps(first)}")
    log(f"query train step {iters + 1}: {json.dumps(last)}")

    # one profiled step: the device's busy time, launches and host syncs
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(batch, gen.manual_seed(99))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_busy_ms(prof)
    rows = {e.key: e for e in prof.key_averages()}
    bwd = {what: sum(device_ms(e) for k, e in rows.items() if k.endswith(name))
           for what, name in (("grid_sample backward (pixel decoder)", "GridSampler2DBackward0"),
                              ("point sampling backward", "_SampleBf16Backward"))}
    casts = device_ms(rows["aten::_to_copy"]) if "aten::_to_copy" in rows else 0.0
    log(f"query train step profile: device busy {busy_ms:.2f} ms (union of kernel "
        f"intervals); profiled step wall {wall_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}; against the unprofiled median step {med * 1e3:.2f} ms, "
        f"idle share {1 - busy_ms / (med * 1e3):.4f}; host calls in the step (the "
        f"script's one closing cudaDeviceSynchronize included): {host_counts(prof)}")
    log("query train step profile, device ms: "
        + "; ".join(f"{k} {v:.2f} ({v / busy_ms:.4f} of busy)" for k, v in bwd.items())
        + f"; dtype casts (aten::_to_copy) {casts:.2f}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
        with open(os.path.join(profile_dir, "query_train_step_profile.txt"), "w") as f:
            f.write(table)
        prof.export_chrome_trace(os.path.join(profile_dir, "query_train_step_trace.json"))
        log(table[:8000])
        # where the stream's time goes, by stage (forward stages by their
        # modules and functions; the optimizer's whole update)
        stages = {
            "encoder (frozen, kernels)": [enc],
            "neck": [model.neck_feature_aggregator, model.neck_feature_spliter],
            "pixel decoder (forward)": [head.pixel_decoder],
            "Mask2Former decoder layers": list(head.transformer_decoder.layers),
            "match cost + Hungarian": [(head, "_match_cost"),
                                       (head_mod, "hungarian_match_batched")],
            "dense prompts of the matched (SamMaskEmbedding)": [head.sam_mask_embed],
            "SAM decode of the matched prompts": [head.mask_decoder],
            "point sampling (forward)": [(head_mod, "uncertain_point_coords"),
                                         (head_mod, "sample_mask_points_bf16")],
            "optimizer (clip + AdamW)": [(opt, "step")],
        }
        split = stage_ms(stages, lambda: trainer.step(batch, gen.manual_seed(98)), iters=3)
        log("query train step: stream ms per stage (forward stages; backward in the "
            "profile rows above): " + "; ".join(f"{k} {v:.2f}" for k, v in split.items()))

    query_gradient_check(trainer, batch, gen)
    return counts


def query_gradient_check(trainer, batch, gen, what: str = "query step"):
    """Phase 10's gradient check: phase 6's rule on the query step
    (:func:`query_gradient_ratios`) at ``QUERY_GRAD_STATES`` trained states,
    ``QUERY_GRAD_GAP`` steps apart; the median over the states of each ratio
    is held to ``FLOOR_FACTOR``. A defect of the kernels raises the ratio at
    every state, the noise of one state's sample at a few."""
    ratios = {"median": [], "worst": []}
    for i in range(QUERY_GRAD_STATES):
        for j in range(QUERY_GRAD_GAP if i else 0):
            trainer.step(batch, gen.manual_seed(3000 + QUERY_GRAD_GAP * i + j))
        for stat, (got, base) in query_gradient_ratios(trainer.model, batch, gen).items():
            ratios[stat].append(got / base)
            log(f"gradient check, {what}, state {i}, {stat} tensor: kernels {got:.4g} from "
                f"the reference, plain bf16 {base:.4g}; ratio {got / base:.4g}")
    for stat, r in ratios.items():
        med = statistics.median(r)
        msg = (f"gradient check, {what}, {stat} tensor: ratio at {len(r)} states "
               f"{[round(x, 4) for x in r]}, median {med:.4g} (limit {FLOOR_FACTOR})")
        log(msg)
        if med > FLOOR_FACTOR:
            raise AssertionError(msg)


def query_gradient_ratios(model, batch, gen, hold_masks: bool = True):
    """The query step's gradients against a reference. One
    batch with fixed draws through the kernels, through the plain versions,
    and through the plain versions with the encoder computing in fp32 (the
    reference; its outputs rounded to bf16 before the neck reads them). The
    three runs take the kernels' run's discrete choices, as phase 6 takes
    its proposals: the matches, the selected points and the decoder's
    cross-attention masks (plus logits thresholded at 0). Random weights'
    costs, uncertainties and mask logits hold near-ties that bf16 noise
    reorders or flips; the share of attention-mask entries each run would
    have flipped is logged. Returns the kernels' and the plain bf16 run's
    distances from the reference, per head parameter, at the median and at
    the worst tensor. ``hold_masks=False`` lets each run make its own masks
    (``scripts/torch_query_grad_check.py`` compares the two)."""
    import torch

    from rsprompter_tpu_torch.apis.build import set_compute_dtype
    from rsprompter_tpu_torch.engine.train_state import total_loss
    from rsprompter_tpu_torch.models.dense_heads import mask2former_head as head_mod

    enc = model.backbone
    head_cls = head_mod.Mask2FormerHead
    match_fn, coords_fn = head_mod.hungarian_match_batched, head_mod.uncertain_point_coords
    mask_fn = head_cls.__dict__["_next_attn_mask"]
    kept = {"match": None, "coords": [], "call": 0, "masks": [], "mask_call": 0,
            "flipped": 0, "entries": 0}

    def keep_match(*a):
        if kept["match"] is None:
            kept["match"] = match_fn(*a)
        return kept["match"]

    def keep_coords(*a, **kw):
        i, kept["call"] = kept["call"], kept["call"] + 1
        if i == len(kept["coords"]):
            kept["coords"].append(coords_fn(*a, **kw))
        return kept["coords"][i]

    def keep_mask(*a):
        am = mask_fn.__func__(*a)
        i, kept["mask_call"] = kept["mask_call"], kept["mask_call"] + 1
        if i == len(kept["masks"]):
            kept["masks"].append(am)
        kept["flipped"] += int((am != kept["masks"][i]).sum())
        kept["entries"] += am.numel()
        return kept["masks"][i]

    def to_bf16(_mod, _inputs, outputs):
        return outputs[0].to(torch.bfloat16), tuple(t.to(torch.bfloat16) for t in outputs[1])

    def grads(impl, what):
        enc.impl = impl
        model.zero_grad(set_to_none=True)
        kept.update(call=0, mask_call=0, flipped=0, entries=0)
        total_loss(model.loss(batch, generator=gen.manual_seed(7))).backward()
        if what and hold_masks:
            log(f"query gradient check: the {what} run would have flipped "
                f"{kept['flipped']} of {kept['entries']} cross-attention mask entries "
                f"({kept['flipped'] / kept['entries']:.4g}) of the kernels' run")
        return {n: p.grad.float().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    head_mod.hungarian_match_batched, head_mod.uncertain_point_coords = keep_match, keep_coords
    if hold_masks:
        head_cls._next_attn_mask = staticmethod(keep_mask)
    hook = enc.register_forward_hook(to_bf16)
    try:
        kernel = grads("kernel", "")
        plain = grads("plain", "plain bf16")
        set_compute_dtype(enc, torch.float32, cast_params=False)
        ref = grads("plain", "fp32-encoder reference")
    finally:
        hook.remove()
        head_mod.hungarian_match_batched, head_mod.uncertain_point_coords = match_fn, coords_fn
        head_cls._next_attn_mask = mask_fn
        set_compute_dtype(enc, torch.bfloat16, cast_params=False)
        enc.impl = "kernel"
        model.zero_grad(set_to_none=True)
    if any(n.startswith("backbone") for n in kernel):
        raise AssertionError("query gradient check: a gradient reached the frozen encoder")
    floor = relative_grad_diffs(plain, ref)
    kernel_ref = relative_grad_diffs(kernel, ref)
    check_grads("query step, plain bf16 vs fp32-encoder reference (the floor)", floor, None)
    check_grads("query step, kernels vs fp32-encoder reference", kernel_ref, None)
    return {what: (stat(kernel_ref.values()), stat(floor.values()))
            for what, stat in (("median", statistics.median), ("worst", max))}


# ---------------------------------------------------------------------------
# phase 11: the training loop (tools.train) on the card
# ---------------------------------------------------------------------------

LOOP_TRAIN_SIZES = tuple((700 + 20 * i, 900 + 6 * i) for i in range(16))  # 16 PNGs
LOOP_VAL_SIZES = ((720, 930), (860, 1000), (1000, 960), (780, 900))
LOOP_EPOCHS = 4  # of 4 steps: 16 images at batch 4
ADAM_STEP_BOUND = 0.1 / (1 - 0.999) ** 0.5  # max |m_hat / sqrt(v_hat)|: (1-b1) / sqrt(1-b2)


def _loop_options(train_root: str, val_root: str):
    opts = [f"max_epochs={LOOP_EPOCHS}", "val_interval=4", "ckpt_interval=3",
            "log_interval=4", "train_dataloader.num_workers=2"]
    for split, root in (("train", train_root), ("val", val_root), ("test", val_root)):
        opts += [f"{split}_dataloader.dataset.data_root={root}",
                 f"{split}_dataloader.dataset.ann_file=ann.json",
                 f"{split}_dataloader.dataset.data_prefix.img=imgs"]
    return opts


def _read_records(work_dir: str):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_loop_phase(kernels, profile_dir: str = "", config: str = TRAIN_CONFIG,
                     device: str = "cuda") -> dict:
    """Phase 11. ``tools.train``'s main on the scratch-512 config over a
    synthetic NWPU-named set: 4 epochs of 4 steps with a validation and
    checkpoints; a second main resumed from the step-12 checkpoint for the
    fourth epoch; ``tools.test`` on its last checkpoint. Returns the
    kernels' launch counts over one profiled epoch of the loop. (``config``
    and ``device='cpu'`` rehearse it at a small size on the CPU.)"""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from rsprompter_tpu_torch.engine.checkpoint import CKPT_FILE, load_train_checkpoint
    from rsprompter_tpu_torch.engine.checkpoint import restore_checkpoint
    from rsprompter_tpu_torch.engine.runner import upload
    from rsprompter_tpu_torch.tools import test as test_tool
    from rsprompter_tpu_torch.tools import train as train_tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        train_root = synthetic_coco(os.path.join(tmp, "train"), NWPU_CLASSES, LOOP_TRAIN_SIZES,
                                    write_png, seed=2)
        val_root = synthetic_coco(os.path.join(tmp, "val"), NWPU_CLASSES, LOOP_VAL_SIZES,
                                  write_png, seed=3)
        opts = _loop_options(train_root, val_root)
        on_card = device == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        log(f"train loop set: {len(LOOP_TRAIN_SIZES)} train PNGs of {LOOP_TRAIN_SIZES[0]}.."
            f"{LOOP_TRAIN_SIZES[-1]}, {len(LOOP_VAL_SIZES)} val PNGs, written in "
            f"{time.time() - t0:.2f} s")

        # run 1: four epochs straight
        work1, work2 = os.path.join(tmp, "run1"), os.path.join(tmp, "run2")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        runner = train_tool.main([config, "--work-dir", work1, "--device", device,
                                  "--cfg-options", *opts])
        wall1 = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        trainer, loader = runner.trainer, runner.train_loader
        spe, bsz = len(loader), loader.batch_size
        rec1 = _read_records(work1)
        train1 = [r for r in rec1 if "loss" in r]
        bad = [r["iter"] for r in train1 if not all(
            math.isfinite(v) for v in r.values() if isinstance(v, float))]
        if bad or [r["iter"] for r in train1] != [4, 8, 12, 16]:
            raise AssertionError(f"train loop: records {[r['iter'] for r in train1]}, "
                                 f"non-finite at {bad}")
        if not [r for r in rec1 if "coco/bbox_mAP" in r]:
            raise AssertionError("train loop: no validation record")
        for d in ("ckpts/step_12", "ckpts/step_16", "best_bbox_mAP", "best_segm_mAP"):
            if not os.path.exists(os.path.join(work1, d)):
                raise AssertionError(f"train loop: {d} missing")
        step_rates = [r["it_per_s"] for r in train1[1:]]  # the first holds the warm-up
        ckpt_file = os.path.join(work1, "ckpts", "step_16", CKPT_FILE)
        ckpt_mb = os.path.getsize(ckpt_file) / 1e6
        log(f"train loop run 1: {len(train1) * 4} steps in {spe} steps/epoch x {LOOP_EPOCHS} "
            f"epochs, batch {bsz}, in {wall1:.2f} s with 1 validation and "
            f"{len(runner.save_ms)} checkpoint saves; steps/s by logged epoch "
            f"{[round(r['it_per_s'], 4) for r in train1]}, after the first: median "
            f"{statistics.median(step_rates):.4f} steps/s, "
            f"{statistics.median(step_rates) * bsz:.3f} images/s; peak device memory "
            f"{peak_gb:.2f} GiB; checkpoint {ckpt_mb:.1f} MB, saves "
            f"{[round(ms, 1) for ms in runner.save_ms]} ms")
        log(f"train loop run 1 losses: {[round(r['loss'], 5) for r in train1]}")

        # the loader alone (decode, augment, collate; its own thread ahead)
        t2 = time.perf_counter()
        n_img = sum(sum(m["img_id"] != -1 for m in metas) for _, metas in loader)
        loader_ips = n_img / (time.perf_counter() - t2)
        batch_np, _ = next(iter(loader))
        up = {}
        for pin in (True, False, True, False):
            sync()
            ta = time.perf_counter()
            upload(batch_np, trainer.device, pin=pin)
            sync()
            up.setdefault(pin, []).append((time.perf_counter() - ta) * 1e3)
        log(f"train loader alone: {n_img} images in one epoch, {loader_ips:.3f} images/s "
            f"({loader_ips / bsz:.3f} batches/s against the loop's "
            f"{statistics.median(step_rates):.4f} steps/s); upload of one batch "
            f"({sum(v.nbytes for v in batch_np.values()) / 1e6:.1f} MB) pinned "
            f"{min(up[True]):.2f} ms, pageable {min(up[False]):.2f} ms")
        del runner, trainer
        if on_card:
            torch.cuda.empty_cache()

        # run 2: a fresh main resumed from step 12 for the fourth epoch
        os.makedirs(os.path.join(work2, "ckpts"))
        os.rename(os.path.join(work1, "ckpts", "step_12"), os.path.join(work2, "ckpts", "step_12"))
        shutil.rmtree(os.path.join(work1, "best_bbox_mAP"))
        shutil.rmtree(os.path.join(work1, "best_segm_mAP"))
        runner = train_tool.main([config, "--work-dir", work2, "--resume", "--device", device,
                                  "--cfg-options", *opts])
        trainer = runner.trainer
        rec2 = _read_records(work2)
        train2 = [r for r in rec2 if "loss" in r]
        val2 = [r for r in rec2 if "coco/bbox_mAP" in r]
        if ([(r["epoch"], r["iter"]) for r in train2] != [(3, 16)] or len(val2) != 1
                or trainer.iter != 16 or runner.train_loader.epoch != LOOP_EPOCHS):
            raise AssertionError(f"resume: records {[(r['epoch'], r['iter']) for r in train2]}, "
                                 f"step {trainer.iter}, loader epoch {runner.train_loader.epoch}")
        if not math.isfinite(train2[0]["loss"]):
            raise AssertionError(f"resume: non-finite loss {train2[0]}")
        # the continuation against run 1's fourth epoch: the two runs' updates
        # each stay within Adam's step bound, lr (|m/sqrt(v)| + wd |w|) a step
        a = load_train_checkpoint(ckpt_file)["model"]
        b = load_train_checkpoint(os.path.join(work2, "ckpts", "step_16"))["model"]
        sched, wd = trainer.optimizer.schedule, trainer.cfg.get("weight_decay", 0.05)
        lr_sum = sum(sched(i) for i in range(12, 16))
        params = {n for n, _ in trainer.model.named_parameters()}
        diffs = {n: (a[n].float() - b[n].float()).abs().max().item() for n in params}
        worst = max(diffs, key=diffs.get)
        bound = 2 * lr_sum * (ADAM_STEP_BOUND + wd * max(a[n].abs().max().item() for n in diffs))
        n_exact = sum(v == 0 for v in diffs.values())
        # BN statistics follow the forward's values: no step bound applies
        bn = {n: ((a[n].float() - b[n].float()).abs().max() / a[n].float().abs().max()).item()
              for n in a if n not in params and a[n].is_floating_point()}
        log(f"resume: run 2 took steps 13-16 from step 12 at loader epoch 3; loss at step 16 "
            f"{train2[0]['loss']:.6f} (run 1 {train1[-1]['loss']:.6f}); step-16 parameters "
            f"against run 1's: {n_exact} of {len(diffs)} bitwise equal, median max|diff| "
            f"{statistics.median(diffs.values()):.3e}, worst {diffs[worst]:.3e} ({worst}), "
            f"bound {bound:.3e} (Adam's step bound over lr {lr_sum:.3e}); {len(bn)} BN "
            f"statistics: worst max|diff| / max|value| {max(bn.values()):.3e}")
        if diffs[worst] > bound or not all(math.isfinite(v) for v in bn.values()):
            raise AssertionError(f"resume: {worst} differs by {diffs[worst]} > {bound}")

        # the restore itself: every tensor and moment equal to the file's
        saved = load_train_checkpoint(os.path.join(work2, "ckpts", "step_12"))
        restore_checkpoint(os.path.join(work2, "ckpts", "step_12"), trainer)
        own = trainer.model.state_dict()
        wrong = [n for n, v in saved["model"].items() if not torch.equal(own[n].cpu(), v)]
        adam_own = trainer.optimizer.adamw.state_dict()["state"]
        adam_saved = saved["optimizer"]["adamw"]["state"]
        wrong += [f"adamw {i} {k}" for i, st in adam_saved.items() for k, v in st.items()
                  if not torch.equal(adam_own[i][k].cpu(), v)]
        if (wrong or trainer.iter != 12 or trainer.optimizer.count != saved["optimizer"]["count"]
                or adam_own.keys() != adam_saved.keys()):
            raise AssertionError(f"restore: {len(wrong)} tensors differ (first: {wrong[:3]})")
        log(f"restore: {len(saved['model'])} model tensors and {len(adam_saved)} parameters' "
            f"moments on the card equal to the step-12 file's; step {trainer.iter}, "
            f"update count {trainer.optimizer.count}")

        # one profiled epoch of the loop (upload, step, a log point)
        for k in kernels:
            k.reset_counts()
        from torch.profiler import ProfilerActivity, profile

        sync()
        t3 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
            runner.train_epoch(LOOP_EPOCHS)
            sync()
        wall_ms = (time.perf_counter() - t3) * 1e3
        counts = {k.name: dict(k.variant_launches) for k in kernels}
        if on_card:
            check_train_launches("train loop", counts, trainer.model, spe)
        busy_ms = device_busy_ms(prof)
        host = host_counts(prof)
        per_step = {k: round(v / spe, 2) for k, v in host.items()}
        log(f"train loop profile ({spe} steps): device busy {busy_ms:.2f} ms of {wall_ms:.2f} "
            f"ms wall, idle share {1 - busy_ms / wall_ms:.4f}; a step: {per_step}; kernels "
            f"per step as phase 5 counts: {counts}")
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            with open(os.path.join(profile_dir, "train_loop_profile.txt"), "w") as f:
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50))

        # tools.test on run 2's last checkpoint against its last validation
        report = test_tool.main([config, os.path.join(work2, "ckpts", "step_16"),
                                 "--device", device, "--cfg-options", *opts])
        tested = dict(report["metrics"], **report["digest"])
        last = val2[-1]
        cmp = {k: (last[k], tested[k]) for k in tested}
        # equal: the inferencer's bf16 parameters are the values the trainer's
        # fp32 ones take at each use (rel-pos tables and pos-embed included)
        differ = [k for k, (v, t) in cmp.items()
                  if not (v == t or (math.isnan(v) and math.isnan(t)))]
        if differ or cmp.keys() != set(last) - {"epoch"}:
            raise AssertionError(f"validation against tools.test: {differ} differ, keys "
                                 f"{sorted(cmp)} against {sorted(last)}")
        log("validation (trainer's module, fp32 master weights cast at use) equals tools.test "
            "on the step-16 checkpoint (bf16 parameters): " + json.dumps(cmp))
        del runner, trainer, report
    if on_card:
        torch.cuda.empty_cache()
    log(f"train loop phase: {time.time() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 12: LoRA and the peft configs
# ---------------------------------------------------------------------------

PEFT_CONFIG = os.path.join(ROOT, "configs", "rsprompter", "rsprompter_anchor-nwpu-peft-512.py")
PEFT_QUERY_CONFIG = os.path.join(ROOT, "configs", "rsprompter",
                                 "rsprompter_query-nwpu-peft-512.py")
PEFT_BATCH = 4  # the scratch-512 cell's batch (the config's loader says 2)
PEFT_QUERY_STEPS = 3
# the seeded adapters' b: s (z la) lb about half of z W at the seeded init
# (a trained adapter moves qkv by a fraction of it); zeroing them moves the
# plain encoder far past twice ENCODER_TOL. At LORA_B_STD_WIDE the adapters'
# term is as large as z W, and the sharper softmax read kernels vs plain
# 0.07867 on an H100: phase 12 reports that reading beside both bf16
# encoders' distance from an fp32 one, and gates the other.
LORA_B_STD = 0.02
LORA_B_STD_WIDE = 0.05


def lora_candidate_b(x, w, b, la, lb, scale, heads3, n):
    """The adapter beside K12' rather than folded into it: K12' on x alone,
    plus ((x la) lb) * scale as two torch products added head-major (timed
    against :func:`fused_mlp.qkv_headmajor_lora`, which won)."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm

    y = fm.qkv_headmajor(x, w, b, heads3, n)
    d = ((x @ la) @ lb) * scale
    return (y + d.reshape(n, -1, heads3, 64).permute(0, 2, 1, 3)).contiguous()


def lora_kernel_rows(dev, bsz: int = PEFT_BATCH, grid: int = 32, path: str = "peft_train_step"):
    """K12' with the adapter at the peft step's shapes (ViT-B 512^2, batch
    4: 36 windows of 196 rows, 4 images of 1024; with ``bsz`` and ``grid``
    another path's: phase 14's 50 windows and 2 images of 4096 at 1024^2,
    batch 2), held against ``qkv_headmajor_lora_plain``; both candidates
    timed, forward and forward + backward. Returns the kernel rows, each
    marked with ``path``."""
    import torch

    from rsprompter_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cpu").manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, torch.bfloat16)

    c, heads3, r, scale = 768, 36, 16, 2.0
    w, b = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    la, lb = rnd(c, r, scale=1.0 / r), rnd(r, 3 * c, scale=LORA_B_STD)
    rows = []
    n_win = bsz * (-(-grid // 14)) ** 2  # windows of the padded grid
    for variant, n_img, s in (("window", n_win, 196), ("global", bsz, grid * grid)):
        x = rnd(n_img * s, c)
        a = (x, w, b, la, lb, scale, heads3, n_img)
        got = fm.qkv_headmajor_lora(*a)
        got_b = lora_candidate_b(*a)
        torch.cuda.synchronize()
        ref = fm.qkv_headmajor_lora_plain(*[v.float() if torch.is_tensor(v) else v for v in a])
        err = compare(f"qkv_headmajor_lora/{variant}", got, ref)
        err_b = compare(f"qkv_headmajor_lora/{variant} (candidate b)", got_b, ref)

        def library(x=x, n_img=n_img):  # composed of bf16 PyTorch calls
            y = torch.nn.functional.linear(x, w, b) + ((x @ la) @ lb) * scale
            return y.reshape(n_img, -1, heads3, 64).permute(0, 2, 1, 3).contiguous()

        m = n_img * s
        flops = 2.0 * m * c * 3 * c + 2.0 * m * c * r + 2.0 * m * r * 3 * c
        nbytes = (x.numel() + w.numel() + b.numel() + la.numel() + lb.numel()
                  + got.numel()) * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        ms_a = cuda_time_ms(lambda: fm.qkv_headmajor_lora(*a))
        ms_b = cuda_time_ms(lambda: lora_candidate_b(*a))
        dy = rnd(*got.shape)
        leaves = [t.detach().requires_grad_(True) for t in (x, w, b, la, lb)]

        def fwd_bwd(fn):
            out = fn(*leaves, scale, heads3, n_img)
            return torch.autograd.grad(out, leaves, dy)

        train_a, train_b = cuda_time_ms(lambda: fwd_bwd(fm.qkv_headmajor_lora)), \
            cuda_time_ms(lambda: fwd_bwd(lora_candidate_b))
        busy = {k: device_ms_per_call(f) for k, f in (
            ("(a)", lambda: fm.qkv_headmajor_lora(*a)), ("(b)", lambda: lora_candidate_b(*a)),
            ("(a) forward + backward", lambda: fwd_bwd(fm.qkv_headmajor_lora)),
            ("(b) forward + backward", lambda: fwd_bwd(lora_candidate_b)))}
        for ga, gb in zip(fwd_bwd(fm.qkv_headmajor_lora), fwd_bwd(lora_candidate_b)):
            compare(f"qkv_headmajor_lora/{variant} gradients, (a) vs (b)", ga, gb)
        log(f"K12' with the adapter, {variant} (x {tuple(x.shape)}, r {r}): candidate (a) "
            f"folded into K (C + 64 = {c + fm.LORA_K_PAD}) {ms_a:.4f} ms, forward + backward "
            f"{train_a:.4f} ms; candidate (b) K12' + two torch products added head-major "
            f"{ms_b:.4f} ms, forward + backward {train_b:.4f} ms (CUDA events, back to back); "
            f"device busy a call (profiler): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in busy.items())
            + f"; max_abs_err (a) {err:.4g}, (b) {err_b:.4g}")
        rows.append(dict(
            name=f"qkv_headmajor_lora/{variant}", kernel=fm.QKV_HEADMAJOR, variant=variant,
            route="cuda", source="rsprompter_tpu_torch/csrc/ln_qkv_headmajor.cu",
            replaces="rsprompter_tpu/ops/fused_mlp.py:154", path=path,
            shape=f"x {tuple(x.shape)} + adapter r {r} -> {tuple(got.shape)} bf16",
            max_abs_err=err, ms=ms_a,
            plain_ms=cuda_time_ms(lambda: fm.qkv_headmajor_lora_plain(*a)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_time_ms(library),
        ))
    return rows


def device_ms_per_call(fn, calls: int = 20) -> float:
    """The device's busy time (union of kernel intervals) a call, from a
    profile of ``calls`` back-to-back calls: what the card spends, apart
    from the host's time to enqueue it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof) / calls


def write_hf_sam(path: str, model_cfg, seed: int) -> dict:
    """A seeded SAM state_dict under Hugging Face's names at the 1024^2 the
    SAM file is made at (the detector's SAM subtrees with the port's seeded
    init, no LoRA adapter: SAM has none), saved to ``path``."""
    import torch

    from rsprompter_tpu_torch.apis.build import build_detector, init_random_weights
    from rsprompter_tpu_torch.engine.checkpoint import SAM_SUBTREE_PREFIXES

    model = build_detector(dict(model_cfg, image_size=1024))
    init_random_weights(model, seed)
    hf = {}
    for name, t in model.state_dict().items():
        for prefix, hf_prefix in SAM_SUBTREE_PREFIXES[model_cfg["type"]].items():
            if name.startswith(prefix) and "lora" not in name:
                hf[hf_prefix + name[len(prefix):]] = t.clone()
    torch.save(hf, path)
    return hf


def seed_lora_b(model, seed: int, std: float = LORA_B_STD) -> int:
    """Every ``qkv_lora_b`` to seeded N(0, std) values (at init they are
    zero, and a dropped adapter could not be seen). Returns the count."""
    import torch

    g = torch.Generator().manual_seed(seed)
    names = []
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("qkv_lora_b"):
                p.copy_(torch.randn(p.shape, generator=g) * std)
                names.append(n)
    return len(names)


def peft_phase(kernels, iters: int, profile_dir: str = "", config: str = PEFT_CONFIG,
               query_config: str = PEFT_QUERY_CONFIG, device: str = "cuda"):
    """Phase 12. Returns the anchor peft step's launch counts over its timed
    steps. (``config``, ``query_config`` and ``device='cpu'`` rehearse it at
    a small size on the CPU, without the launch checks.)"""
    import tempfile

    import torch

    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    t_phase = time.time()
    on_card = device == "cuda"
    # --- 1. the anchor peft train step --------------------------------------
    cfg = Config.fromfile(config)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pytorch_model.bin")
        hf = write_hf_sam(path, cfg["model"], seed=2)
        cfg.merge_from_options({"model.hf_sam_pretrain_ckpt_path": path})
        trainer = build_trainer(cfg, device=device, seed=0,
                                steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    model, opt = trainer.model, trainer.optimizer
    enc = model.backbone
    depth = enc.config.num_hidden_layers
    resized = {"pos_embed"} | {f"layers.{i}.attn.rel_pos_{a}"
                                for i in enc.config.global_attn_indexes for a in "hw"}
    loaded = 0
    for n, p in enc.named_parameters():
        if "lora" in n:
            if n.endswith("qkv_lora_b") and bool(p.detach().any()):
                raise AssertionError(f"peft: {n} is not at its zero init after the SAM load")
        elif n not in resized:
            if not torch.equal(p.detach().cpu(), hf["vision_encoder." + n]):
                raise AssertionError(f"peft: {n} differs from the SAM file")
            loaded += 1
    grid = (enc.config.grid_size,) * 2
    if tuple(enc.pos_embed.shape[1:3]) != grid:
        raise AssertionError(f"peft: pos_embed {tuple(enc.pos_embed.shape)} for a {grid} grid")
    n_lora = seed_lora_b(model, seed=3)
    trained = {n for n, _ in opt.trained}
    lora_names = {n for n in trained if "qkv_lora" in n}
    if ({n for n in trained if n.startswith("backbone")} != lora_names
            or len(lora_names) != 2 * depth):
        raise AssertionError(f"peft: the encoder's trained tensors are not its adapters: "
                             f"{sorted(n for n in trained if n.startswith('backbone'))[:6]}")
    size = tuple(cfg["crop_size"])
    batch = {k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        PEFT_BATCH, size, cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    gen = torch.Generator(device=device)

    log(f"peft train step: RSPrompter-anchor peft (LoRA r 16, alpha 32 on qkv; pseudo "
        f"aggregator), ViT-B {size[0]}x{size[1]}, batch {PEFT_BATCH}, bf16 compute, fp32 "
        f"master weights, a seeded 1024^2 SAM file through the {size[0]}^2 resize ({loaded} "
        f"encoder tensors equal to the file's), {n_lora} adapters with seeded qkv_lora_b")
    run = baseline_steps("peft train step", trainer, batch, iters, kernels,
                         unreached_ok=(UNREACHED,), device=device, profile_dir=profile_dir,
                         lora=True)
    if not lora_names <= run["reached"]:
        raise AssertionError(f"peft train step: adapters not reached "
                             f"{lora_names - run['reached']}")
    if profile_dir:
        run["prof"].export_chrome_trace(os.path.join(profile_dir, "peft_train_step_trace.json"))
        from rsprompter_tpu_torch.ops import fused_mlp as fm

        split = stage_ms({
            "encoder (LoRA route)": [enc],
            "LN1 + window partition (torch)": [(fm, "layer_norm"), (fm, "window_partition")],
            "K12' with the adapter": [(fm, "qkv_headmajor_lora")],
            "neck (pseudo aggregator + FPN)": [model.neck_feature_aggregator,
                                               model.neck_feature_spliter],
            "optimizer (clip + AdamW)": [(opt, "step")],
        }, lambda: trainer.step(batch, gen.manual_seed(98)), iters=3)
        log("peft train step: stream ms per stage (forward stages; backward in "
            "peft_train_step_profile.txt): " + "; ".join(f"{k} {v:.2f}" for k, v in split.items()))

    gradient_phase(model, opt, lambda: model.loss(batch, generator=gen.manual_seed(7)),
                   only=trained)
    del trainer, model, opt, batch
    if on_card:
        torch.cuda.empty_cache()

    # --- 2. anchor peft predict ----------------------------------------------
    peft_predict(kernels, config, device)

    # --- 3. the query peft train step ---------------------------------------
    peft_query_train(kernels, query_config, device)
    log(f"peft phase: {time.time() - t_phase:.1f} s")
    return run["counts"]


def peft_predict(kernels, config: str = PEFT_CONFIG, device: str = "cuda") -> None:
    """Part 2 of phase 12: ``init_detector`` / ``inference_detector`` on the
    anchor peft config at 512^2, batch 2, every ``qkv_lora_b`` seeded; launch
    counts; the encoder through the kernels against plain, and plain with
    the adapters' b zeroed, which must move by more than twice that limit."""
    import copy

    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.build import set_compute_dtype
    from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
    from rsprompter_tpu_torch.models.preprocess import preprocess_images

    on_card = device == "cuda"
    model = init_detector(config, device=device, batch_size=2, seed=0)
    det = model.model
    enc = det.backbone
    seed_lora_b(det, seed=3)
    imgs = synthetic_images(0)
    inference_detector(model, imgs)
    for k in kernels:
        k.reset_counts()
    preds = inference_detector(model, imgs)
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    depth = enc.config.num_hidden_layers
    n_global = len(enc.config.global_attn_indexes)
    per_kind = {"global": n_global, "window": depth - n_global}
    expect = {"ln_mlp_residual": mlp_launches(depth), "ln_rows": {"mlp": depth},
              "ln_qkv_headmajor": {}, "relpos_attention": per_kind, "qkv_headmajor": per_kind}
    for name, want in expect.items():
        if on_card and counts[name] != want:
            raise AssertionError(f"peft predict: {name} launches {counts[name]}, expected {want}")
    for img, p in zip(imgs, preds):
        if not (np.isfinite(p["bboxes"]).all() and np.isfinite(p["scores"]).all()):
            raise AssertionError("peft predict: non-finite detections")
        if p["masks"].shape[1:] != img.shape[:2]:
            raise AssertionError(f"peft predict: masks {p['masks'].shape} for {img.shape}")
    batch, _ = model.make_batch(imgs)
    x = preprocess_images(batch["images"])
    lbs = [p for n, p in enc.named_parameters() if n.endswith("qkv_lora_b")]

    def run(impl, module=enc, inputs=x):
        module.impl = impl
        with torch.no_grad():
            out = module(inputs)
        enc.impl = "kernel"
        return out

    def readings():
        """The encoder through the kernels, through plain, and through plain
        in fp32 (the bf16 noise's yardstick)."""
        ref_enc = copy.deepcopy(enc).float()
        set_compute_dtype(ref_enc, torch.float32, cast_params=False)
        return run("kernel"), run("plain"), run("plain", ref_enc, x.float())

    out_k, out_p, out_ref = readings()
    saved = [t.detach().clone() for t in lbs]
    with torch.no_grad():
        for t in lbs:
            t.zero_()
    out_nolora = run("plain")
    seed_lora_b(det, seed=3, std=LORA_B_STD_WIDE)  # report only: adapters as large as z W
    wide = readings()
    with torch.no_grad():
        for t, v in zip(lbs, saved):
            t.copy_(v)
    if not all(torch.isfinite(a.float()).all() for a in (out_k[0],) + out_k[1]):
        raise AssertionError("peft predict: non-finite encoder output")
    worst = worst_rel_diff(out_k, out_p)
    effect = worst_rel_diff(out_nolora, out_p)
    per_out = [f"{rel_diff(a, b):.4g}" for a, b in zip((out_k[0],) + out_k[1],
                                                        (out_p[0],) + out_p[1])]
    log(f"peft predict: encoder kernels vs plain per output (neck, then hidden states 0-"
        f"{len(out_k[1]) - 1}): {', '.join(per_out)}; against the plain encoder in fp32: "
        f"kernels {worst_rel_diff(out_k, out_ref):.4g}, plain bf16 "
        f"{worst_rel_diff(out_p, out_ref):.4g}; with qkv_lora_b at N(0, {LORA_B_STD_WIDE}) "
        f"(not gated): kernels vs plain {worst_rel_diff(wide[0], wide[1]):.4g}, against fp32 "
        f"kernels {worst_rel_diff(wide[0], wide[2]):.4g}, plain bf16 "
        f"{worst_rel_diff(wide[1], wide[2]):.4g}")
    size = enc.config.image_size
    log(f"peft predict: RSPrompter-anchor peft, ViT-B {size}^2, batch 2, bf16, {depth} adapters "
        f"seeded at N(0, {LORA_B_STD}): launches {counts.get('qkv_headmajor')} K12' with the "
        f"adapter, {counts.get('relpos_attention')} C, {counts.get('ln_mlp_residual')} A, B 0; "
        f"detections per image {[len(p['bboxes']) for p in preds]}; encoder kernels vs plain: "
        f"worst max|diff|/max|plain| {worst:.4g} over neck + {len(out_k[1])} hidden states (tol "
        f"{ENCODER_TOL}); the same measure with every qkv_lora_b zeroed (plain): {effect:.4g}")
    if worst > ENCODER_TOL:
        raise AssertionError(f"peft predict: encoder kernels vs plain {worst:.4g} > {ENCODER_TOL}")
    if effect < 2 * ENCODER_TOL:
        raise AssertionError(f"peft predict: dropping the adapters moves the encoder by "
                             f"{effect:.4g}, too little for the {ENCODER_TOL} check to see")
    del model, det, enc, out_k, out_p, out_ref, out_nolora, wide
    if on_card:
        torch.cuda.empty_cache()


def peft_query_train(kernels, config: str = PEFT_QUERY_CONFIG, device: str = "cuda") -> None:
    """Part 3 of phase 12: the query peft config, ``PEFT_QUERY_STEPS`` steps
    after a warm-up: finite losses, the adapters move, the rest of the
    encoder stays, B and B' never launch."""
    import torch

    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trainer = build_trainer(config, device=device, seed=0,
                            steps_per_epoch=QUERY_TRAIN_STEPS_PER_EPOCH)
    model, cfg = trainer.model, trainer.cfg
    seed_lora_b(model, seed=4)
    bsz = cfg["train_dataloader"]["batch_size"]
    size = tuple(cfg["crop_size"])
    batch = {k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        bsz, size, cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    gen = torch.Generator(device=device)
    trainer.step(batch, gen.manual_seed(0))
    sync()
    enc_before = {n: p.detach().clone() for n, p in model.backbone.named_parameters()}
    for k in kernels:
        k.reset_counts()
    times = []
    for i in range(PEFT_QUERY_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.step(batch, gen.manual_seed(1 + i))
        sync()
        times.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        if bad:
            raise AssertionError(f"peft query train step {i + 1}: non-finite {bad}")
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    for n, p in model.backbone.named_parameters():
        moved = not torch.equal(p.detach(), enc_before[n])
        if moved != ("qkv_lora" in n):
            raise AssertionError(f"peft query train step: {n} moved {moved}")
    if on_card and (counts["ln_qkv_headmajor"] or counts["ln_qkv_headmajor_bwd"]
                    or counts["ln_rows"].keys() != {"mlp"} or not counts["qkv_headmajor"]
                    or not counts["ln_mlp_residual_bwd"]):
        raise AssertionError(f"peft query train step: launches {counts} (B and B' must not "
                             "launch, K12', A' must)")
    log(f"peft query train step: RSPrompter-query peft, ViT-B {size[0]}x{size[1]}, batch "
        f"{bsz}: {statistics.median(times):.4f} s/step median of {PEFT_QUERY_STEPS}; loss "
        f"{float(metrics['loss']):.4f}, grad_norm {float(metrics['grad_norm']):.4f}; the "
        f"adapters moved, the rest of the encoder did not; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    del trainer, model
    if on_card:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: SAM-det and the SAM-seg baselines' predict
# ---------------------------------------------------------------------------

SAM_BASELINES = {
    "samdet": os.path.join(ROOT, "configs", "rsprompter", "samdet-nwpu.py"),
    "samseg_maskrcnn": os.path.join(ROOT, "configs", "rsprompter", "samseg-maskrcnn-nwpu.py"),
    "samseg_mask2former": os.path.join(ROOT, "configs", "rsprompter",
                                       "samseg-mask2former-nwpu.py"),
}
# oracle prompts of phase 13: (x1, y1, x2, y2) in each synthetic image's
# original pixels, and their classes
ORACLE_GT = (((60, 80, 400, 300), (500, 420, 900, 760), (100, 500, 300, 780)),
             ((40, 30, 380, 520), (420, 600, 840, 940)))
ORACLE_LABELS = ((3, 0, 9), (5, 1))


def oracle_gts():
    """Phase 13's ground truth for ``synthetic_images``, as ``load_raw``
    gives it (original pixels, nothing ignored)."""
    import numpy as np

    return [dict(gt_bboxes=np.asarray(b, np.float32), gt_labels=np.asarray(lab),
                 gt_ignore_flags=np.zeros(len(b), bool))
            for b, lab in zip(ORACLE_GT, ORACLE_LABELS)]


def check_pasted(preds) -> int:
    """Every pasted mask empty outside its box (corners rounded outward, as
    ``paste_masks_np`` rounds them). Returns the masks checked."""
    import numpy as np

    n = 0
    for p in preds:
        for box, mask in zip(p["bboxes"], p["masks"]):
            x1, y1 = (int(v) for v in np.floor(box[:2]))
            x2, y2 = (int(v) for v in np.ceil(box[2:]))
            inside = np.zeros_like(mask)
            inside[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = True
            if (mask & ~inside).any():
                raise AssertionError(f"Mask R-CNN: a pasted mask reaches outside its box {box}")
            n += 1
    return n


def sam_baseline_predict(name: str, config: str, kernels, iters: int, imgs, profile_dir: str,
                         device: str):
    """One family of phase 13 through ``init_detector`` / ``inference_detector``:
    timing, launches, finiteness, a profiled forward and the family's own
    gates. Returns the launch counts of the timed forwards."""
    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
    from rsprompter_tpu_torch.models.preprocess import preprocess_images

    on_card = device == "cuda"
    model = init_detector(config, device=device, batch_size=2, seed=0)
    det = model.model
    enc = det.segmentor.vision_encoder if name == "samdet" else det.backbone
    dtype = next(enc.parameters()).dtype
    preds = inference_detector(model, imgs)  # warm-up
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset_counts()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        preds = inference_detector(model, imgs)
        if on_card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    if on_card:
        depth = enc.config.num_hidden_layers
        n_global = len(enc.config.global_attn_indexes)
        per_kind = {"global": n_global * iters, "window": (depth - n_global) * iters}
        expect = {"ln_mlp_residual": mlp_launches(depth * iters),
                  "ln_rows": dict(per_kind, mlp=depth * iters),
                  "ln_qkv_headmajor": per_kind, "relpos_attention": per_kind,
                  "qkv_headmajor": {}}
        if dtype == torch.float32:  # a frozen fp32 encoder: the fp32 variants alone
            expect = f32_variants(expect)
        for kname, want in expect.items():
            if counts[kname] != want:
                raise AssertionError(f"{name}: {kname} launches {counts[kname]}, "
                                     f"expected {want} over {iters} forwards")
    n_dets = []
    for img, p in zip(imgs, preds):
        h, w = img.shape[:2]
        if not all(np.isfinite(p[k]).all() for k in ("bboxes", "scores")):
            raise AssertionError(f"{name}: non-finite detections")
        if p["masks"].shape != (len(p["bboxes"]), h, w) or p["masks"].dtype != np.bool_:
            raise AssertionError(f"{name}: masks {p['masks'].shape} for image {h}x{w}")
        n_dets.append(len(p["bboxes"]))
    batch, _ = model.make_batch(imgs)
    model_ms = []
    for _ in range(3):  # the model alone, without the host's pre- and post-processing
        t0 = time.perf_counter()
        dets, probs = det.predict(batch)
        if on_card:
            torch.cuda.synchronize()
        model_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(torch.isfinite(t.float()).all() for t in (dets.boxes, dets.scores, probs)):
        raise AssertionError(f"{name}: non-finite predict outputs")
    ms = statistics.median(times)
    width = enc.config.hidden_size
    vit = {768: "ViT-B", 1024: "ViT-L", 1280: "ViT-H"}.get(width, f"ViT C={width}")
    log(f"{name}: predict through inference_detector, {vit} 1024^2, batch 2, {dtype}: "
        f"{ms:.2f} ms/batch median of {iters} ({', '.join(f'{t:.2f}' for t in times)}), "
        f"{2e3 / ms:.3f} images/s, peak memory {peak_gb:.2f} GiB; model.predict alone "
        f"{statistics.median(model_ms):.2f} ms median of 3; detections per image "
        f"{n_dets}; masks {tuple(probs.shape)}; launches {counts}")

    if name == "samdet":
        x = preprocess_images(batch["images"])
        with torch.no_grad():
            out_k = enc(x)
            enc.impl = "plain"
            out_p = enc(x)
            enc.impl = "kernel"
        worst = worst_rel_diff(out_k, out_p)
        dts = {str(t.dtype) for t in (out_k[0],) + out_k[1]}
        log(f"samdet: fp32 encoder, fp32 kernels vs plain fp32 (TF32 off), worst "
            f"max|diff|/max|plain| {worst:.4g} over neck + {len(out_k[1])} hidden states "
            f"(tol {F32_ENCODER_TOL}); outputs {dts}")
        if worst > F32_ENCODER_TOL or dts != {"torch.float32"}:
            raise AssertionError(f"samdet: fp32 encoder {worst:.4g} > {F32_ENCODER_TOL} or "
                                 f"{dts}")
        model.oracle = True
        gts = oracle_gts()
        o_dets, o_probs, _ = model.predict_batch(imgs, gts=gts)
        model.oracle = False
        o_batch, _ = model.make_batch(imgs, gts=gts)
        if not (torch.equal(o_dets.scores, o_batch["gt_valid"].float())
                and torch.equal(o_dets.labels, o_batch["gt_labels"])
                and torch.equal(o_dets.valid, o_batch["gt_valid"])):
            raise AssertionError("samdet: oracle scores / labels are not the GT's")
        log(f"samdet: oracle_predict on {sum(len(g['gt_bboxes']) for g in gts)} GT boxes: "
            f"scores equal valid, labels the GT's; masks {tuple(o_probs.shape)}")
    if name == "samseg_maskrcnn":
        if tuple(probs.shape) != (2, 100, 28, 28):
            raise AssertionError(f"Mask R-CNN: mask probabilities {tuple(probs.shape)}")
        log(f"samseg_maskrcnn: {check_pasted(preds)} pasted masks, each empty outside its box")

    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inference_detector(model, imgs)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy = device_busy_ms(prof)
        log(f"{name} profile: device busy {busy:.2f} ms (union of kernel intervals) in a "
            f"profiled forward of {wall_ms:.2f} ms, idle share {1 - busy / wall_ms:.4f}; "
            f"against the unprofiled median {ms:.2f} ms, idle share {1 - busy / ms:.4f}; "
            f"host calls {host_counts(prof)}")
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
            with open(os.path.join(profile_dir, f"{name}_profile.txt"), "w") as f:
                f.write(table)
    del model, det, enc
    if on_card:
        torch.cuda.empty_cache()
    return counts


def sam_baselines_phase(kernels, iters: int, profile_dir: str = "", configs=None,
                        device: str = "cuda", eval_sizes=EVAL_SIZES):
    """Phase 13: SAM-det (fp32, its encoder through the fp32 kernels), SAM-seg
    Mask R-CNN (bf16, RoI masks pasted) and SAM-seg Mask2Former (bf16, 70
    queries) at ViT-B 1024^2, batch 2, on phase 3's images; then
    ``tools.test`` over phase 9's synthetic set with Mask R-CNN (paste:
    every key finite) and with SAM-det ``--oracle`` (bbox mAP 1.0).
    Returns each family's launch counts."""
    import tempfile

    import numpy as np

    from rsprompter_tpu_torch.tools import test as tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t_start = time.time()
    configs = configs or SAM_BASELINES
    imgs = synthetic_images(0)
    counts = {name: sam_baseline_predict(name, cfg, kernels, iters, imgs, profile_dir, device)
              for name, cfg in configs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_coco(tmp, NWPU_CLASSES, eval_sizes, write_png, seed=0)
        data = ["--cfg-options", f"test_dataloader.dataset.data_root={tmp}",
                "test_dataloader.dataset.ann_file=ann.json",
                "test_dataloader.dataset.data_prefix.img=imgs"]
        rcnn = tool.main([configs["samseg_maskrcnn"], "--device", device] + data)
        bad = [k for k in JAX_TOOL_KEYS if not np.isfinite(rcnn["metrics"].get(k, float("nan")))]
        if bad or rcnn["inferencer"].mask_mode != "paste":
            raise AssertionError(f"Mask R-CNN tools.test: keys missing or not finite {bad}, "
                                 f"mask mode {rcnn['inferencer'].mask_mode}")
        oracle = tool.main([configs["samdet"], "--oracle", "--device", device] + data)
        if oracle["metrics"]["coco/bbox_mAP"] != 1.0:
            raise AssertionError(f"SAM-det --oracle: bbox mAP {oracle['metrics']}")
    for what, r in (("samseg_maskrcnn", rcnn), ("samdet --oracle", oracle)):
        t = r["timing"]
        log(f"tools.test {what}: {t['images']} images in {t['wall_s']:.3f} s "
            f"({t['images'] / t['wall_s']:.3f} images/s), predict {t['predict_s']:.3f} s, "
            f"metric.process {t['process_s']:.3f} s; metrics " + json.dumps(r["metrics"]))
    del rcnn, oracle
    log(f"phase 13: {time.time() - t_start:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 14: SAM-det and the SAM-seg baselines' train steps
# ---------------------------------------------------------------------------

BASELINE_STEPS = 10  # timed steps of each family, after one warm-up
PEFT_SEG_STEPS = 3  # the peft Mask R-CNN's timed steps, after one warm-up
NO_PLUS_STEPS = 2  # decoder_plus=False: steps after one predict
BASELINE_STEPS_PER_EPOCH = 260  # NWPU's 520 training images at batch 2
BASELINE_LOSS_TERMS = {"samdet": 4, "samseg_maskrcnn": 5, "samseg_mask2former": 21}
# the query head's mask-feature branch: the two finest neck levels and the
# pixel decoder's path to the mask feature, which only the mask-feature
# product reads (JAX's gradient there is zero too without the plus stream)
MASK_FEATURE_BRANCH = tuple(
    f"neck_feature_spliter.{m}" for m in ("fpn1", "fpn2", "lateral_convs.0", "lateral_convs.1",
                                          "fpn_convs.0", "fpn_convs.1")
) + tuple(f"panoptic_head.pixel_decoder.{m}" for m in ("lateral_convs", "output_convs",
                                                         "mask_feature"))
# device kernels of A, B and C (their forward launches), by name in a profile
FORWARD_KERNEL_NAMES = ("ln_rows_kernel", "mlp_gemm_kernel", "qkv_gemm_kernel",
                        "relpos_attention_kernel", "window_kernel")


def baseline_train_batch(device: str, crop: int = 1024):
    """Phase 3's two images in a ``crop``^2 batch (keep-ratio resize and
    pad, as ``make_batch`` does) with phase 13's GT boxes scaled into it and,
    in each box, the 0/1 mask of its inscribed ellipse (uint8, three GT
    slots; the second image fills two)."""
    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import PAD_VALUE_BGR, _target_size
    from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2

    imgs, gts = synthetic_images(0), oracle_gts()
    g = max(len(gt["gt_bboxes"]) for gt in gts)
    images = torch.empty((len(imgs), crop, crop, 3), dtype=torch.uint8, device=device)
    images[...] = torch.tensor(np.round(PAD_VALUE_BGR), dtype=torch.uint8)
    shapes = np.zeros((len(imgs), 2), np.int32)
    boxes = np.zeros((len(imgs), g, 4), np.float32)
    labels = np.zeros((len(imgs), g), np.int64)
    valid = np.zeros((len(imgs), g), bool)
    masks = np.zeros((len(imgs), g, crop, crop), np.uint8)
    yy, xx = np.mgrid[0:crop, 0:crop] + 0.5
    for i, (img, gt) in enumerate(zip(imgs, gts)):
        h, w = img.shape[:2]
        nh, nw = _target_size(h, w, (crop, crop))
        x = resize_bilinear_cv2(torch.as_tensor(img, device=device), (nh, nw))
        images[i, :nh, :nw] = x.round().clamp(0, 255).to(torch.uint8)
        shapes[i] = (nh, nw)
        n = len(gt["gt_bboxes"])
        boxes[i, :n] = gt["gt_bboxes"] * np.array([nw / w, nh / h] * 2, np.float32)
        labels[i, :n], valid[i, :n] = gt["gt_labels"], True
        for j, (x1, y1, x2, y2) in enumerate(boxes[i, :n]):
            cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
            masks[i, j] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
    batch = dict(img_shape=shapes, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                 gt_masks=masks)
    return dict(images=images, **{k: torch.as_tensor(v, device=device) for k, v in batch.items()})


def frozen_forward_launches(enc, steps: int) -> dict:
    """A, B and C for every encoder layer in each of ``steps`` forwards,
    and no backward kernel (a frozen encoder)."""
    depth = enc.config.num_hidden_layers
    n_global = len(enc.config.global_attn_indexes)
    per_kind = {"global": n_global * steps, "window": (depth - n_global) * steps}
    return {"ln_mlp_residual": mlp_launches(depth * steps),
            "ln_rows": dict(per_kind, mlp=depth * steps), "ln_qkv_headmajor": per_kind,
            "relpos_attention": per_kind, "ln_mlp_residual_bwd": {},
            "ln_qkv_headmajor_bwd": {}, "relpos_attention_bwd": {}, "qkv_headmajor": {}}


def check_launches(what: str, counts: dict, expect: dict) -> None:
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"{what}: {name} launches {counts[name]}, expected {want}")


def check_matches(what: str, matched, valid, n_calls: int, n_queries: int) -> None:
    """Each solve's matches (calls x B, G): -1 exactly at invalid GT, one-to-one
    per image, inside the queries."""
    import torch

    for m in matched:
        if m.numel() != n_calls * valid.numel():
            raise AssertionError(f"{what}: matches of shape {tuple(m.shape)}")
        m = m.reshape(n_calls, *valid.shape)
        if not torch.equal(m == -1, ~valid.expand_as(m)):
            raise AssertionError(f"{what}: matches {m.tolist()} against valid {valid.tolist()}")
        for row, v in zip(m.reshape(-1, m.shape[-1]), valid.repeat(n_calls, 1)):
            picked = row[v]
            if len(set(picked.tolist())) != len(picked) or picked.max() >= n_queries:
                raise AssertionError(f"{what}: matches {row.tolist()} not one-to-one")


def gather_index_stats(run, min_numel: int = 1 << 16) -> list:
    """The index of every large 1-D row gather that ``run()`` makes (the
    RoI extractor's corner gather: ``aten.index`` on the card,
    ``index_select`` on the CPU): its length, distinct rows, the largest
    group of one row and the share of indices in groups of more than 64.
    The deterministic backward of the card's gather sums each group in
    turn, so a large group costs time in proportion."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    stats = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.index.Tensor:
                idx = [i for i in args[1] if i is not None]
                idx = idx[0] if len(idx) == 1 else None
            elif func is torch.ops.aten.index_select.default and args[1] == 0:
                idx = args[2]
            else:
                idx = None
            if idx is not None and idx.dim() == 1 and idx.numel() >= min_numel:
                _, counts = torch.unique(idx, return_counts=True)
                top = torch.topk(counts, min(5, counts.numel())).values.tolist()
                stats.append(dict(indices=idx.numel(), distinct=counts.numel(),
                                  largest_groups=top,
                                  share_in_groups_over_64=float(
                                      counts[counts > 64].sum() / idx.numel())))
            return out

    with torch.no_grad(), Record():
        run()
    return stats


def baseline_steps(what: str, trainer, batch, steps: int, kernels,
                   loss_terms: Optional[int] = None, unreached_ok=(), device: str = "cuda",
                   profile_dir: str = "", gathers: bool = False,
                   lora: Optional[bool] = None) -> dict:
    """One warm-up and ``steps`` timed steps (phases 12, 14 and 16): every
    metric finite (with ``loss_terms`` loss terms, where given), every frozen
    tensor bitwise unchanged, every trained tensor the loss reaches with a
    finite gradient and moved (only ``unreached_ok`` prefixes may go
    unreached); on the card with ``lora`` given, exact launch counts
    (``check_train_launches``, ``lora``: the LoRA route); then one profiled
    step (with ``gathers``, its RoI gathers' indices counted first, from its
    forward on the same weights and draws). Returns the launch counts,
    times, the profile and the step's figures."""
    import torch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model, opt = trainer.model, trainer.optimizer
    gen = torch.Generator(device=device)

    def check(metrics, when):
        bad = [k for k, v in metrics.items() if not torch.isfinite(v).all()]
        terms = [k for k in metrics if "loss" in k and k != "loss"]
        if bad or loss_terms not in (None, len(terms)):
            raise AssertionError(f"{what} step {when}: non-finite {bad}, {len(terms)} loss "
                                 f"terms (expected {loss_terms})")
        return {k: float(v) for k, v in metrics.items()}

    first = check(trainer.step(batch, gen.manual_seed(0)), "warm-up")
    sync()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trained = {n for n, _ in opt.trained}
    reached = set()
    for k in kernels:
        k.reset_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = trainer.step(batch, gen.manual_seed(1 + i))
        sync()
        times.append(time.perf_counter() - t0)
        missed = [n for n in opt.unreached if not n.startswith(unreached_ok)]
        if missed:
            raise AssertionError(f"{what} step: no gradient reached {missed[:6]}")
        reached |= trained - set(opt.unreached)
        last = check(metrics, f"{i + 1}")
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        if n not in trained and moved:
            raise AssertionError(f"{what} step: the frozen {n} moved")
        if n in reached and (not moved or p.grad is None or not torch.isfinite(p.grad).all()):
            raise AssertionError(f"{what} step: {n} did not move or has no finite gradient")
    del before
    if on_card and lora is not None:
        check_train_launches(what, counts, model, steps, lora=lora)
    med = statistics.median(times)
    if gathers:
        gathers = gather_index_stats(lambda: model.loss(batch, generator=gen.manual_seed(99)))

    from torch.profiler import ProfilerActivity, profile

    sync()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        trainer.step(batch, gen.manual_seed(99))
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_busy_ms(prof)
    log(f"{what}: {med:.4f} s/step median of {steps} (min {min(times):.4f}, max "
        f"{max(times):.4f}), {batch['images'].shape[0] / med:.3f} images/s; peak device memory "
        f"{peak_gb:.2f} GiB; {len(opt.trained)} trained / {len(opt.frozen)} frozen tensors, "
        f"every frozen one bitwise unchanged, {len(reached)} trained ones moved, not reached: "
        f"{len(trained - reached)}; one profiled step: device busy {busy_ms:.2f} ms (union of "
        f"kernel intervals) of {wall_ms:.2f} ms wall, idle share {1 - busy_ms / wall_ms:.4f}; "
        f"against the unprofiled median step, idle share {1 - busy_ms / (med * 1e3):.4f}; host "
        f"calls in the step (the script's closing cudaDeviceSynchronize included): "
        f"{host_counts(prof)}; launches over the timed steps "
        f"{ {n: c for n, c in counts.items() if c} }")
    log(f"{what}: step times (s) {[round(t, 4) for t in times]}"
        + (f"; the profiled step's large row gathers (its forward again, without gradient): "
           f"{json.dumps(gathers)}" if gathers else ""))
    log(f"{what} step 1 (warm-up): {json.dumps(first)}")
    log(f"{what} step {steps + 1}: {json.dumps(last)}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, what.replace(" ", "_") + "_profile.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    return dict(counts=counts, med=med, times=times, prof=prof, busy_ms=busy_ms,
                peak_gb=peak_gb, last=last, reached=reached)


def baseline_trainer(config, sam_file: str, device: str, options=None):
    """``build_trainer`` on ``config`` over the seeded SAM file, with
    ``options`` merged into the config."""
    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.engine.train_state import build_trainer

    cfg = Config.fromfile(config) if isinstance(config, str) else config
    cfg.merge_from_options(dict(options or {}, **{"model.hf_sam_pretrain_ckpt_path": sam_file}))
    return build_trainer(cfg, device=device, seed=0, steps_per_epoch=BASELINE_STEPS_PER_EPOCH)


def baselines_train_phase(kernels, iters: int = BASELINE_STEPS, profile_dir: str = "",
                          configs=None, device: str = "cuda", dev=None,
                          eval_sizes=EVAL_SIZES, crop: int = 1024):
    """Phase 14. Returns each path's launch counts and the rows of A', C'
    and K12' with the adapter at the peft Mask R-CNN step's shapes.
    (``configs``, ``crop`` and ``device='cpu'`` rehearse it at a small size
    on the CPU, without the launch checks and the kernel rows.)"""
    import tempfile

    import torch

    from rsprompter_tpu_torch.models.dense_heads import mask2former_head as head_mod
    from rsprompter_tpu_torch.models.task_modules import hungarian

    t_phase = time.time()
    on_card = device == "cuda"
    configs = configs or dict(SAM_BASELINES, query=QUERY_CONFIG)
    card = card_line() if on_card else "cpu"
    paths, rows = {}, []
    batch = baseline_train_batch(device, crop)
    valid = batch["gt_valid"].cpu()
    with tempfile.TemporaryDirectory() as tmp:
        from rsprompter_tpu_torch.core.config import Config

        sam_file = os.path.join(tmp, "pytorch_model.bin")
        write_hf_sam(sam_file, Config.fromfile(configs["samdet"])["model"], seed=5)

        # --- SAM-det: the detector alone trains ----------------------------
        trainer = baseline_trainer(configs["samdet"], sam_file, device)
        seg_before = {n: p.detach().clone() for n, p in trainer.model.segmentor.named_parameters()}
        out = baseline_steps("samdet train", trainer, batch, iters, kernels,
                             BASELINE_LOSS_TERMS["samdet"], device=device,
                             profile_dir=profile_dir, gathers=True)
        for n, p in trainer.model.segmentor.named_parameters():
            if p.grad is not None or not torch.equal(p.detach(), seg_before[n]):
                raise AssertionError(f"samdet train: segmentor.{n} moved or got a gradient")
        moved_parts = {n.split(".")[0] for n in out["reached"]}
        if moved_parts != {"backbone", "neck", "rpn_head", "roi_head"}:
            raise AssertionError(f"samdet train: the trained parts that moved {moved_parts}")
        own = sum(e.count for e in out["prof"].key_averages()
                  if any(k in e.key for k in FORWARD_KERNEL_NAMES))
        if on_card and (own or any(out["counts"].values())):
            raise AssertionError(f"samdet train: the encoder kernels launched ({own} in the "
                                 f"profile, counts {out['counts']})")
        log(f"samdet train: SAM-det (ResNet-50 + FPN + RPN + bbox head, fp32, no TF32), "
            f"1024^2, batch 2: {len(seg_before)} segmentor tensors bitwise unchanged and without "
            f"gradient; {own} launches of A, B and C in the profiled step and none counted "
            f"[{card}]")
        paths["samdet_train_step"] = out["counts"]
        del trainer, out, seg_before
        if on_card:
            torch.cuda.empty_cache()

        # --- SAM-seg Mask R-CNN, encoder frozen ------------------------------
        trainer = baseline_trainer(configs["samseg_maskrcnn"], sam_file, device)
        out = baseline_steps("samseg_maskrcnn train", trainer, batch, iters, kernels,
                             BASELINE_LOSS_TERMS["samseg_maskrcnn"], device=device,
                             profile_dir=profile_dir, gathers=True)
        model = trainer.model
        if any(p.grad is not None for p in model.backbone.parameters()):
            raise AssertionError("samseg_maskrcnn train: a gradient reached the frozen encoder")
        if on_card:
            check_launches("samseg_maskrcnn train", out["counts"],
                           frozen_forward_launches(model.backbone, iters))
        gather = next((e for e in out["prof"].key_averages() if e.key == "IndexBackward0"), None)
        gather_ms = device_ms(gather) if gather is not None else float("nan")
        n_gather = gather.count if gather is not None else 0
        log(f"samseg_maskrcnn train: Mask R-CNN on the frozen SAM encoder (bf16 on fp32 "
            f"master weights), 1024^2, batch 2, 512 RoIs an image, 128 mask slots: A, B, C "
            f"as the frozen forward counts, no backward kernel; the RoI gather's backward "
            f"(IndexBackward0, the bbox head's 7^2 and the mask head's 14^2 extraction) "
            f"{gather_ms:.3f} device ms over {n_gather} calls in the profiled step, "
            f"{gather_ms / max(n_gather, 1):.3f} ms a call [{card}]")
        paths["samseg_maskrcnn_train_step"] = out["counts"]
        gen = torch.Generator(device=device)
        gradient_phase(model, trainer.optimizer,
                       lambda: model.loss(batch, generator=gen.manual_seed(7)),
                       only={n for n, _ in trainer.optimizer.trained})
        del trainer, model, out, gather
        if on_card:
            torch.cuda.empty_cache()

        # --- SAM-seg Mask R-CNN with the anchor peft config's LoRA ------------
        peft = Config.fromfile(configs.get("peft", PEFT_CONFIG))["model"]
        trainer = baseline_trainer(configs["samseg_maskrcnn"], sam_file, device, {
            "model.peft_config": dict(peft["peft_config"]),
            "model.aggregator_type": peft["aggregator_type"]})
        model = trainer.model
        n_lora = seed_lora_b(model, seed=6)
        trained = {n for n, _ in trainer.optimizer.trained}
        lora = {n for n in trained if "qkv_lora" in n}
        if {n for n in trained if n.startswith("backbone.")} != lora or not lora:
            raise AssertionError("samseg_maskrcnn peft: the encoder's trained tensors are not "
                                 "its adapters")
        out = baseline_steps("samseg_maskrcnn peft train", trainer, batch, PEFT_SEG_STEPS,
                             kernels, BASELINE_LOSS_TERMS["samseg_maskrcnn"], device=device,
                             profile_dir=profile_dir, gathers=True, lora=True)
        moved_enc = {n for n in out["reached"] if n.startswith("backbone.")}
        if moved_enc != lora:
            raise AssertionError(f"samseg_maskrcnn peft: encoder tensors moved {moved_enc ^ lora}")
        log(f"samseg_maskrcnn peft train: LoRA r {peft['peft_config']['r']} alpha "
            f"{peft['peft_config']['lora_alpha']} on qkv, {peft['aggregator_type']} aggregator, "
            f"{n_lora} adapters with seeded qkv_lora_b: K12' with the adapter, C, A, C' and A' "
            f"launch, B and B' none; only the {len(lora)} adapter tensors move in the "
            f"encoder [{card}]")
        paths["samseg_maskrcnn_peft_train_step"] = out["counts"]
        gen = torch.Generator(device=device)
        gradient_phase(model, trainer.optimizer,
                       lambda: model.loss(batch, generator=gen.manual_seed(7)), only=trained)
        del trainer, model, out
        if on_card:
            torch.cuda.empty_cache()
            bsz, grid = batch["images"].shape[0], crop // 16
            path = "samseg_maskrcnn_peft_train_step"
            rows = backward_kernel_phase(dev, bsz=bsz, grid=grid, kinds=("A'", "C'"), path=path)
            rows += lora_kernel_rows(dev, bsz=bsz, grid=grid, path=path)
            log(f"samseg_maskrcnn peft: A', C' and K12' with the adapter against plain at this "
                f"path's shapes: "
                + "; ".join(f"{r['name']} {r['shape']}: max_abs_err {r['max_abs_err']:.4g}, "
                            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                            f"{r['bound_ms']:.4f} {r['bound_by']})" for r in rows)
                + f" [{card}]")

        # --- SAM-seg Mask2Former and the query head without the plus stream --
        solves = []
        lsa_fn = hungarian._lsa_host_batched

        def recorded_lsa(*a):
            out = lsa_fn(*a)
            solves.append(torch.from_numpy(out))
            return out

        hungarian._lsa_host_batched = recorded_lsa
        try:
            trainer = baseline_trainer(configs["samseg_mask2former"], sam_file, device)
            solves.clear()
            out = baseline_steps("samseg_mask2former train", trainer, batch, iters, kernels,
                                 BASELINE_LOSS_TERMS["samseg_mask2former"], device=device,
                                 profile_dir=profile_dir)
            head = trainer.model.panoptic_head
            last = out["last"]
            own_total = sum(v for k, v in last.items() if k.startswith("loss_"))
            if abs(last["loss"] - own_total) > 1e-4 * abs(own_total):
                raise AssertionError(f"samseg_mask2former: total {last['loss']} is not the "
                                     f"last call's three terms {own_total}")
            if len(solves) != iters + 2:  # the timed steps, the warm-up and the profiled one
                raise AssertionError(f"samseg_mask2former: {len(solves)} Hungarian solves in "
                                     f"{iters + 2} steps")
            check_matches("samseg_mask2former", solves, valid, head.num_head_calls,
                          head.num_queries)
            if on_card:
                check_launches("samseg_mask2former train", out["counts"],
                               frozen_forward_launches(trainer.model.backbone, iters))
            log(f"samseg_mask2former train: the stock Mask2Former head, {head.num_queries} "
                f"queries, {head.num_points} points, 1024^2, batch 2: 21 loss terms, the total "
                f"the last call's three; one Hungarian solve (one host copy) a step, every "
                f"match one-to-one [{card}]")
            paths["samseg_mask2former_train_step"] = out["counts"]
            del trainer, out, head
            if on_card:
                torch.cuda.empty_cache()
            paths["query_no_plus_train_step"] = no_plus_query(
                kernels, configs["query"], sam_file, batch, solves, device, card, profile_dir)
        finally:
            hungarian._lsa_host_batched = lsa_fn

        # --- tools.train, then tools.test, on Mask R-CNN ----------------------
        maskrcnn_train_tool(configs["samseg_maskrcnn"], sam_file, tmp, eval_sizes, device)
    log(f"phase 14: {time.time() - t_phase:.1f} s")
    return paths, rows


def no_plus_query(kernels, config: str, sam_file: str, batch, solves, device: str,
                  card: str, profile_dir: str = "") -> dict:
    """Phase 14's query part: ``decoder_plus=False`` through
    ``init_detector`` / ``inference_detector`` (each call decodes all its
    queries) and ``NO_PLUS_STEPS`` train steps after a warm-up; phase 10's
    gates (finite, 21 terms, the frozen encoder without gradient, launches,
    one match solve a step, one-to-one), and its gradient check."""
    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
    from rsprompter_tpu_torch.core.config import Config

    on_card = device == "cuda"
    cfg = Config.fromfile(config)
    cfg.merge_from_options({"model.decoder_plus": False,
                            "model.hf_sam_pretrain_ckpt_path": sam_file})
    model = init_detector(cfg, device=device, batch_size=2, seed=0)
    imgs = synthetic_images(0)
    inference_detector(model, imgs)
    for k in kernels:
        k.reset_counts()
    t0 = time.perf_counter()
    preds = inference_detector(model, imgs)
    predict_ms = (time.perf_counter() - t0) * 1e3
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    head = model.model.panoptic_head
    if not head.chain_decodes or hasattr(head, "mask_embed"):
        raise AssertionError("query decoder_plus=False: the head has a plus stream")
    if on_card:
        check_launches("query decoder_plus=False predict", counts,
                       frozen_forward_launches(model.model.backbone, 1))
    for img, p in zip(imgs, preds):
        if not (np.isfinite(p["bboxes"]).all() and np.isfinite(p["scores"]).all()):
            raise AssertionError("query decoder_plus=False predict: non-finite detections")
        if p["masks"].shape[1:] != img.shape[:2]:
            raise AssertionError(f"query decoder_plus=False predict: masks {p['masks'].shape}")
    log(f"query decoder_plus=False predict: {predict_ms:.2f} ms for batch 2 (one call, "
        f"7 x {head.num_queries} prompts decoded); detections per image "
        f"{[len(p['bboxes']) for p in preds]} [{card}]")
    del model, preds
    from rsprompter_tpu_torch.engine.train_state import build_trainer

    trainer = build_trainer(cfg, device=device, seed=0,
                            steps_per_epoch=QUERY_TRAIN_STEPS_PER_EPOCH)
    solves.clear()
    out = baseline_steps("query decoder_plus=False train", trainer, batch,
                         NO_PLUS_STEPS, kernels, 21,
                         unreached_ok=MASK_FEATURE_BRANCH + (UNREACHED_QUERY,),
                         device=device, profile_dir=profile_dir)
    model = trainer.model
    head = model.panoptic_head
    if any(p.grad is not None for p in model.backbone.parameters()):
        raise AssertionError("query decoder_plus=False: a gradient reached the frozen encoder")
    if len(solves) != NO_PLUS_STEPS + 2:
        raise AssertionError(f"query decoder_plus=False: {len(solves)} Hungarian solves")
    check_matches("query decoder_plus=False", solves, batch["gt_valid"].cpu(),
                  head.num_head_calls, head.num_queries)
    if on_card:
        check_launches("query decoder_plus=False train", out["counts"],
                       frozen_forward_launches(model.backbone, NO_PLUS_STEPS))
    log(f"query decoder_plus=False train: RSPrompter-query, {head.num_queries} queries, "
        f"each call's SAM decode of every query the next attention mask, 1024^2, batch 2: "
        f"21 loss terms, one Hungarian solve a step, the frozen encoder without gradient; "
        f"not reached: the mask-feature branch and {UNREACHED_QUERY}* alone [{card}]")
    gen = torch.Generator(device=device)
    query_gradient_check(trainer, batch, gen, "query decoder_plus=False step")
    del trainer, model
    if on_card:
        torch.cuda.empty_cache()
    return out["counts"]


def maskrcnn_train_tool(config: str, sam_file: str, tmp: str, eval_sizes, device: str) -> None:
    """``tools.train``'s main on SAM-seg Mask R-CNN over phase 9's PNGs: one
    epoch of 2 steps (the first four images), a checkpoint and a validation
    with paste over all of them; then ``tools.test`` on the checkpoint must
    read the same keys, as phase 11 holds it."""
    import math

    from rsprompter_tpu_torch.apis.inference import mask_mode_of
    from rsprompter_tpu_torch.tools import test as test_tool
    from rsprompter_tpu_torch.tools import train as train_tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t0 = time.time()
    train_root = synthetic_coco(os.path.join(tmp, "train"), NWPU_CLASSES, eval_sizes[:4],
                                write_png, seed=0)
    val_root = synthetic_coco(os.path.join(tmp, "val"), NWPU_CLASSES, eval_sizes, write_png,
                              seed=0)
    opts = ["max_epochs=1", "val_interval=1", "ckpt_interval=1", "log_interval=1",
            "train_dataloader.num_workers=2", f"model.hf_sam_pretrain_ckpt_path={sam_file}"]
    for split, root in (("train", train_root), ("val", val_root), ("test", val_root)):
        opts += [f"{split}_dataloader.dataset.data_root={root}",
                 f"{split}_dataloader.dataset.ann_file=ann.json",
                 f"{split}_dataloader.dataset.data_prefix.img=imgs"]
    work = os.path.join(tmp, "maskrcnn")
    runner = train_tool.main([config, "--work-dir", work, "--device", device,
                              "--cfg-options", *opts])
    records = _read_records(work)
    train = [r for r in records if "loss" in r]
    val = [r for r in records if "coco/bbox_mAP" in r]
    if ([r["iter"] for r in train] != [1, 2] or len(val) != 1
            or not all(math.isfinite(r["loss"]) for r in train)):
        raise AssertionError(f"Mask R-CNN tools.train: records {records}")
    ckpt = os.path.join(work, "ckpts", "step_2")
    report = test_tool.main([config, ckpt, "--device", device, "--cfg-options", *opts])
    modes = {mask_mode_of(runner.trainer.model), report["inferencer"].mask_mode}
    if modes != {"paste"}:
        raise AssertionError(f"Mask R-CNN: the validation's and tools.test's mask modes {modes}")
    tested = dict(report["metrics"], **report["digest"])
    last = val[-1]
    cmp = {k: (last[k], tested[k]) for k in tested}
    differ = [k for k, (v, t) in cmp.items() if not (v == t or (math.isnan(v) and math.isnan(t)))]
    if differ or cmp.keys() != set(last) - {"epoch"}:
        raise AssertionError(f"Mask R-CNN validation against tools.test: {differ} differ, keys "
                             f"{sorted(cmp)} against {sorted(last)}")
    log(f"Mask R-CNN tools.train: 1 epoch of 2 steps at batch 2 (losses "
        f"{[round(r['loss'], 5) for r in train]}), a checkpoint and a validation with paste; "
        f"tools.test on the step-2 checkpoint reads the same keys: {json.dumps(cmp)}; "
        f"{time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the ViT-L and ViT-H widths
# ---------------------------------------------------------------------------

WIDE_PATHS = {"large": "vit_l_encoder", "huge": "vit_h_predict"}  # where each arch's rows count
WIDE_PREDICT_NAME = "facebook/sam-vit-huge"


def wide_kernel_rows(dev) -> list:
    """Kernels A, B (with its row pass) and C at ViT-L's (C 1024, 16 heads of
    64) and ViT-H's (C 1280, 16 heads of 80) widths, 1024^2, batch 2, each
    against its plain version; each arch's rows count launches on its path
    (``WIDE_PATHS``)."""
    import torch

    from rsprompter_tpu_torch.models.sam.configs import sam_config

    g = torch.Generator(device="cpu").manual_seed(2)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    rows = []
    bsz, grid, win = 2, 64, 14
    for arch, path in WIDE_PATHS.items():
        v = sam_config(arch).vision_config
        c, heads = v.hidden_size, v.num_attention_heads
        tag = f"@vit-{arch[0]}"
        arch_rows = [mlp_row(rnd, dev, bsz * grid * grid, c, tag)]
        arch_rows += qkv_rows(rnd, dev, bsz, grid, c, heads, win, tag)
        arch_rows += attention_rows(rnd, bsz, grid, heads, c // heads, win, tag)
        for r in arch_rows:
            r["path"] = path
        rows += arch_rows
        torch.cuda.empty_cache()
    log_rows(rows)
    return rows


def wide_encoder_check(arch: str, kernels, dev, seed: int = 0,
                       attn_impl: str = "fused", f32: bool = False) -> dict:
    """The arch's SAM encoder (seeded) at 1024^2, batch 2, on the
    ``attn_impl`` route through the bf16 kernels, cast to bf16 as a bf16
    config predicts, or with ``f32`` in fp32 through the fp32 ones: the
    launches of one forward, which path kernel C took for the windows and
    the global grid, the kernels against the plain fp32 encoder within
    ``ENCODER_TOL`` (``F32_ENCODER_TOL``) over the neck and every hidden
    state, and plain with the rel-pos tables zeroed moved by more than twice
    that. Returns the forward's launch counts."""
    import copy

    import torch

    from rsprompter_tpu_torch.apis.build import init_random_weights, set_compute_dtype
    from rsprompter_tpu_torch.models.sam.configs import sam_config
    from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    vcfg = sam_config(arch).vision_config
    enc = SamVisionEncoder(vcfg, attn_impl=attn_impl)
    init_random_weights(enc, seed)
    enc.to(dev).eval()
    kern = enc if f32 else set_compute_dtype(copy.deepcopy(enc), torch.bfloat16)
    tol = F32_ENCODER_TOL if f32 else ENCODER_TOL
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(2, vcfg.image_size, vcfg.image_size, 3, generator=g).to(dev)
    tables = [p for n, p in enc.named_parameters() if n.endswith(("rel_pos_h", "rel_pos_w"))]
    with torch.no_grad():
        for k in kernels:
            k.reset_counts()
        out_k = kern(x)
        torch.cuda.synchronize()
        counts = {k.name: dict(k.variant_launches) for k in kernels}
        kernel_ms = cuda_time_ms(lambda: kern(x), warmup=1, iters=3, repeat=1)
        del kern
        enc.impl = "plain"
        out_p = enc(x)
        saved = [t.clone() for t in tables]
        for t in tables:
            t.zero_()
        out_nobias = enc(x)
        for t, v in zip(tables, saved):
            t.copy_(v)
        enc.impl = "kernel"
    expect = frozen_forward_launches(enc, 1)
    if attn_impl == "flash":  # torch LN1 and MLP; K12' and C
        expect = {k: {} for k in expect}
        expect["relpos_attention"] = expect["qkv_headmajor"] = \
            frozen_forward_launches(enc, 1)["relpos_attention"]
    if f32:
        expect = f32_variants(expect)
    check_launches(f"ViT-{arch} encoder ({attn_impl}{', fp32' if f32 else ''})", counts,
                   expect)
    if not all(torch.isfinite(a).all() for a in (out_k[0],) + out_k[1]):
        raise AssertionError(f"ViT-{arch} encoder through the kernels: non-finite output")
    worst = worst_rel_diff(out_k, out_p)
    bias_effect = worst_rel_diff(out_nobias, out_p)
    d = vcfg.hidden_size // vcfg.num_attention_heads
    grid = vcfg.image_size // vcfg.patch_size
    win = vcfg.window_size
    route = ("one path for every grid (fp32)" if f32 else
             f"its {fa.relpos_attention_route((win, win), d)} path for the {win}x{win} "
             f"windows and its {fa.relpos_attention_route((grid, grid), d)} path for the "
             f"{grid}x{grid} grid")
    log(f"ViT-{arch} encoder (C {vcfg.hidden_size}, {vcfg.num_hidden_layers} layers, "
        f"{vcfg.num_attention_heads} heads of {d}), attn_impl={attn_impl!r}, 1024^2, "
        f"batch 2: launches of one forward "
        f"{counts}; kernel C took {route}; kernels ({'fp32' if f32 else 'bf16'} inside) vs "
        f"plain fp32: worst max|diff|/max|plain| {worst:.4g} over neck + {len(out_k[1])} "
        f"hidden states (tol {tol}); rel-pos tables zeroed (plain): {bias_effect:.4g}; "
        f"forward {kernel_ms:.2f} ms through the kernels")
    if not f32 and fa.relpos_attention_route((win, win), d) != "window":
        raise AssertionError(f"ViT-{arch}: kernel C's windows did not take its window path")
    if worst > tol:
        raise AssertionError(f"ViT-{arch} encoder: kernels vs plain {worst:.4g} > {tol}")
    if bias_effect < 2 * tol:
        raise AssertionError(f"ViT-{arch} encoder: the rel-pos bias moves the output by "
                             f"{bias_effect:.4g} only")
    del enc, out_k, out_p, out_nobias
    torch.cuda.empty_cache()
    return counts


def widths_phase(kernels, iters: int, dev, profile_dir: str = "") -> dict:
    """Phase 15: the ViT-L and ViT-H encoders against plain fp32, then
    RSPrompter-anchor predict at ViT-H 1024^2, batch 2 (``hf_sam_pretrain_name``
    overridden, seeded weights, phase 3's images) through ``init_detector`` /
    ``inference_detector``: phase 13's gates (timing, A 32, B and C 28 + 4
    launches a forward, finite outputs, ``model.predict`` alone, peak memory,
    a profiled forward). Returns the launch counts of each path."""
    from rsprompter_tpu_torch.core.config import Config

    t_phase = time.time()
    paths = {}
    for arch, path in WIDE_PATHS.items():
        counts = wide_encoder_check(arch, kernels, dev)
        if path.endswith("_encoder"):
            paths[path] = counts
    cfg = Config.fromfile(CONFIG)
    cfg["model"]["hf_sam_pretrain_name"] = WIDE_PREDICT_NAME
    cfg["model"]["hf_sam_pretrain_ckpt_path"] = None  # seeded weights: no ViT-H file
    counts = sam_baseline_predict("anchor_vit_h", cfg, kernels, iters, synthetic_images(0),
                                  profile_dir, "cuda")
    paths[WIDE_PATHS["huge"]] = counts
    log(f"anchor_vit_h: launches over {iters} forwards {counts}")
    log(f"phase 15: {time.time() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 16: ViT-L and ViT-H training
# ---------------------------------------------------------------------------

# path: (config, SAM name); each at 512^2, batch 4, seeded weights
WIDE_TRAIN = {
    "vit_l_train_step": (TRAIN_CONFIG, "facebook/sam-vit-large"),
    "vit_h_train_step": (TRAIN_CONFIG, "facebook/sam-vit-huge"),
    "vit_h_peft_train_step": (PEFT_CONFIG, "facebook/sam-vit-huge"),
}
WIDE_TRAIN_STEPS = 3  # timed steps of each, after one warm-up
WIDE_FLASH_PATH = "vit_h_flash_encoder"


def k12_hd80_rows(rnd, c: int, heads: int, win: int) -> list:
    """K12' at 16 heads of 80 alone at the shapes of the 'flash' encoder
    check (1024^2, batch 2: 50 windows of 196, 2 images of 4096) and with
    the adapter (r 16, K = C + 64) at the peft step's (512^2, batch 4: 36
    windows of 196, 4 images of 1024), at the windows and the global grid,
    against their plain versions."""
    w, b = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    adapter = (rnd(c, 16, scale=1.0 / 16), rnd(16, 3 * c, scale=LORA_B_STD), 2.0)
    rows = []
    for path, bsz, grid, adapt in ((WIDE_FLASH_PATH, 2, 64, None),
                                   ("vit_h_peft_train_step", PEFT_BATCH, 32, adapter)):
        n_win = bsz * (-(-grid // win)) ** 2  # windows of the padded grid
        for variant, n_img, s in (("window", n_win, win * win), ("global", bsz, grid * grid)):
            name = f"qkv_headmajor{'_lora' if adapt else ''}/{variant}@vit-h"
            rows.append(k12_row(name, rnd(n_img * s, c), w, b, 3 * heads, n_img, variant,
                                path, adapt))
    return rows


def wide_backward_rows(dev) -> list:
    """Phase 16's kernel rows at the train steps' shapes (512^2, batch 4: T
    = 4096 tokens, 36 windows of 196, 4 images of 1024): A' at ViT-L's (C
    1024) and ViT-H's (C 1280) widths, B' and C' at ViT-L's 16 heads of 64
    and ViT-H's 16 heads of 80, each against its fp32 plain version and
    launched twice for the same bits; then K12' at head dim 80 alone and
    with the adapter (``k12_hd80_rows``). Each row counts launches on its
    path."""
    import torch

    from rsprompter_tpu_torch.models.sam.configs import sam_config

    g = torch.Generator(device="cpu").manual_seed(16)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def f32(args):
        return [a.float() if torch.is_tensor(a) else a for a in args]

    bsz, grid, win = PEFT_BATCH, 32, 14
    t, n_win = bsz * grid * grid, bsz * (-(-grid // win)) ** 2
    rows = []
    for arch, path in (("large", "vit_l_train_step"), ("huge", "vit_h_train_step")):
        v = sam_config(arch).vision_config
        c, heads, tag = v.hidden_size, v.num_attention_heads, f"@vit-{arch[0]}"
        ln_w, ln_b = 1 + rnd(c, scale=0.1, dtype=torch.float32), rnd(c, scale=0.1,
                                                                     dtype=torch.float32)
        arch_rows = [a_prime_row(rnd, f32, t, c, 4 * c, ln_w, ln_b, tag)]
        torch.cuda.empty_cache()
        arch_rows += b_prime_rows(rnd, f32, bsz, grid, c, heads, win, n_win, ln_w, ln_b, tag)
        arch_rows += c_prime_rows(rnd, bsz, grid, heads, win, n_win, c // heads, tag)
        rows += [dict(r, path=path) for r in arch_rows]
        torch.cuda.empty_cache()
    v = sam_config("huge").vision_config
    rows += k12_hd80_rows(rnd, v.hidden_size, v.num_attention_heads, win)
    log_rows(rows, "max|plain| per output")
    return rows


def wide_train_step(path: str, config: str, sam_name: str, kernels, steps: int,
                    device: str = "cuda") -> dict:
    """One of phase 16's train steps: ``build_trainer`` on ``config`` with
    ``hf_sam_pretrain_name`` = ``sam_name`` and seeded weights (no L/H
    file), a synthetic batch of 4 at the config's crop, then
    ``baseline_steps`` (one warm-up, ``steps`` timed steps, their gates and
    exact launch counts, s/step, peak memory, a profiled step's busy time and
    idle share), then phase 6's gradient check with the encoder alone held
    to the floor rule (``gradient_phase(encoder_floor=True)``). Returns the
    launch counts of the timed steps. (``device='cpu'`` rehearses it on a
    tiny config, without the launch checks.)"""
    import torch

    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    t0 = time.time()
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    cfg.merge_from_options({"model.hf_sam_pretrain_name": sam_name,
                            "model.hf_sam_pretrain_ckpt_path": None})
    peft = cfg["model"].get("peft_config") is not None
    trainer = build_trainer(cfg, device=device, seed=0, steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    model, opt = trainer.model, trainer.optimizer
    vcfg = model.backbone.config
    if peft:
        seed_lora_b(model, seed=3)
    trained = {n for n, _ in opt.trained}
    size = tuple(cfg["crop_size"])
    batch = {k: torch.as_tensor(v, device=device) for k, v in synthetic_batch(
        PEFT_BATCH, size, cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    d = vcfg.hidden_size // vcfg.num_attention_heads
    what = ("peft (LoRA r 16 on qkv, pseudo aggregator)" if peft
            else "scratch (encoder and decoder trained)")
    log(f"{path}: RSPrompter-anchor {what}, {sam_name} (C {vcfg.hidden_size}, "
        f"{vcfg.num_hidden_layers} layers, {vcfg.num_attention_heads} heads of {d}), seeded "
        f"weights, {size[0]}x{size[1]}, batch {PEFT_BATCH}, bf16 compute, fp32 master weights")
    run = baseline_steps(path, trainer, batch, steps, kernels, unreached_ok=(UNREACHED,),
                         device=device, lora=peft)
    if peft and {n for n in run["reached"] if n.startswith("backbone")} != {
            n for n in trained if "qkv_lora" in n}:
        raise AssertionError(f"{path}: the encoder's trained tensors are not its adapters")
    gen = torch.Generator(device=device)
    gradient_phase(model, opt, lambda: model.loss(batch, generator=gen.manual_seed(7)),
                   only=trained if peft else None, encoder_floor=True)
    del trainer, model, opt, batch
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"{path}: {time.time() - t0:.1f} s")
    return run["counts"]


def wide_train_phase(kernels, steps: int, dev) -> dict:
    """Phase 16: the ViT-H encoder on the 'flash' route against plain fp32
    (K12' and C at head dim 80), then the three train steps of
    ``WIDE_TRAIN``. Returns the launch counts of each path."""
    t_phase = time.time()
    paths = {WIDE_FLASH_PATH: wide_encoder_check("huge", kernels, dev, attn_impl="flash")}
    for path, (config, sam_name) in WIDE_TRAIN.items():
        paths[path] = wide_train_step(path, config, sam_name, kernels, steps)
    log(f"phase 16: {time.time() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 17: the serving surface (JPEG decoder, DetInferencer on paths,
# image_demo, the batched server, oom_guard, large_image_demo, tools.test
# over JPEGs)
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
SERVE_BUCKETS = (512, 1024)
SERVE_MAX_BATCH = 4
SERVE_CLIENTS = 8
# bucket-512 images the server test sends as PNG bytes and PNG paths (the
# bucket-1024 ones are the JPEG fixtures, 600-960 px)
SERVE_SMALL_SIZES = ((300, 420), (512, 384), (360, 500), (480, 480))
SCENE_HW = (2600, 3400)  # the large_image_demo scene
# a served answer against DetInferencer called directly on the same image
# at the same bucket: largest |box diff| (px), |score diff| and the share of
# mask pixels that differ. Twice the worst reading on an H100 80GB HBM3 at
# 700.00 W (0, 0 and 0 over 1600 detections): both run a batch of 4 at one
# bucket, the image in another slot beside other images, and every kernel
# of the path computes a slot's rows alone, in a fixed order, so the
# answers are equal bit for bit.
SERVE_BOX_TOL = 0.0
SERVE_SCORE_TOL = 0.0
SERVE_MASK_TOL = 0.0


def _post(url: str, body: bytes):
    """POST ``body``; returns (status, JSON answer, seconds)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, payload = e.code, json.loads(e.read() or b"{}")
    return status, payload, time.perf_counter() - t0


def latency_line(what: str, lat, wall: float) -> str:
    import numpy as np

    return (f"{what}: {len(lat)} requests in {wall:.3f} s, {len(lat) / wall:.3f} requests/s, "
            f"latency p50 {1e3 * statistics.median(lat):.1f} ms, p99 "
            f"{1e3 * float(np.percentile(lat, 99)):.1f} ms (of {len(lat)})")


def jpeg_fixture_check(reps: int = 5) -> dict:
    """Every committed fixture through the port's decoder: the sha256 of the
    array equal to ``cv2.imread``'s (``tests/data/jpeg/digests.json``),
    OpenCV never imported. Returns {name: host ms a decode (median)}."""
    import hashlib

    from rsprompter_tpu_torch.data.io import imread

    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    ms = {}
    for name, want in sorted(digests.items()):
        path = os.path.join(JPEG_DIR, name)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            img = imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if got != want["sha256"] or list(img.shape) != want["shape"]:
            raise AssertionError(f"JPEG {name}: {img.shape} sha256 {got[:16]}..., cv2.imread "
                                 f"gave {want['shape']} {want['sha256'][:16]}...")
        ms[name] = statistics.median(times)
    if sys.modules.get("cv2") is not None:
        raise AssertionError("the JPEG path imported cv2")
    log("JPEG decoder: " + ", ".join(f"{n} {v:.2f} ms" for n, v in ms.items())
        + f" (host ms a decode, median of {reps}); every array's sha256 equals cv2.imread's; "
        "cv2 not imported")
    return ms


def jpeg_coco(root: str, seed: int = 0) -> str:
    """The JPEG fixtures as a COCO set under ``root``: ``imgs/`` holds them,
    ``ann.json`` GT drawn by ``synthetic_coco`` at their sizes."""
    import shutil

    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    names = sorted(n for n in os.listdir(JPEG_DIR) if n.endswith(".jpg"))
    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    sizes = [tuple(digests[n]["shape"][:2]) for n in names]
    synthetic_coco(root, NWPU_CLASSES, sizes, lambda path, img: None, seed=seed)
    with open(os.path.join(root, "ann.json")) as f:
        ann = json.load(f)
    for im, name in zip(ann["images"], names):
        im["file_name"] = name
        shutil.copy(os.path.join(JPEG_DIR, name), os.path.join(root, "imgs", name))
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump(ann, f)
    return root


def serve_breakdown(inferencer, path: str) -> dict:
    """Host ms of one request's stages outside HTTP, served alone at its
    bucket: decode, the predict (synchronised), the detections and masks to
    the host, RLE and lists (``BatchWorker._post``), the JSON body; and the
    body's bytes."""
    import torch

    from rsprompter_tpu_torch.data.io import imread
    from rsprompter_tpu_torch.tools import serve

    out = {}
    t = time.perf_counter()
    img = imread(path)
    out["decode_ms"] = (time.perf_counter() - t) * 1e3
    side = max(img.shape[:2])
    t = time.perf_counter()
    with inferencer._lock:
        dets, probs, metas = inferencer.predict_batch([img], crop=inferencer._bucket_for(side, side))
        if inferencer.device.type == "cuda":
            torch.cuda.synchronize()
        out["predict_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        pred = inferencer._finish(dets, probs, 0, metas[0], True, 0.0)
    out["to_host_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    answer = serve.BatchWorker._post(pred, serve._Job(img, 0.0, True))
    out["rle_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    body = json.dumps(answer).encode()
    out["json_ms"] = (time.perf_counter() - t) * 1e3
    out["body_mb"] = len(body) / 2**20
    out["dets"] = len(answer["scores"])
    return out


def served_vs_direct(answer: dict, direct: dict) -> tuple:
    """(box, score, mask-share) distances of a served answer from the direct
    prediction; raises where the labels or the count differ."""
    import numpy as np

    from rsprompter_tpu_torch.evaluation import rle

    labels = np.asarray(answer["labels"], np.int64)
    if not np.array_equal(labels, np.asarray(direct["labels"], np.int64)):
        raise AssertionError(f"served labels {labels[:8]}... differ from the direct "
                             f"predict's {direct['labels'][:8]}...")
    if not labels.size:
        return 0.0, 0.0, 0.0
    box = float(np.abs(np.asarray(answer["bboxes"], np.float32).reshape(-1, 4)
                       - direct["bboxes"]).max())
    score = float(np.abs(np.asarray(answer["scores"], np.float32) - direct["scores"]).max())
    masks = np.stack([rle.decode_mask(rle.RLE.from_coco(r)) for r in answer["masks_rle"]])
    share = float((masks != direct["masks"]).mean())
    return box, score, share


def oom_check(inferencer, imgs) -> None:
    """A real CUDA out of memory halved by ``oom_guard``: the allocator is
    capped (``set_per_process_memory_fraction``, after ``empty_cache``) so
    that the batch of 8 fails, its halves fail, and its quarters run; they
    must give the detections of four unguarded batch-2 predicts of the same
    images. The fraction is restored whatever happens.

    The cap lies in the window between what the last quarter needs (a
    batch-2 predict's peak, with three quarters' outputs still held by the
    guard: the first half joined, and the third quarter) and what a half
    needs (a batch-4 predict's peak, nothing held); both counted from the
    memory allocated before the run. A half fails whatever the cache holds,
    since its peak allocation alone passes the cap; the quarters get three
    quarters of the window, since blocks cached beside held outputs count
    against the cap too."""
    import torch

    from rsprompter_tpu_torch.apis.inference import DetInferencer
    from rsprompter_tpu_torch.utils.memory import oom_guard

    model, cfg = inferencer.model, inferencer.cfg
    by_size = {n: DetInferencer.from_module(model, cfg, batch_size=n) for n in (2, 4, 8)}
    need = {}  # the peak allocation a predict adds, at batch 2 and 4
    for n in (2, 4):
        batch, _ = by_size[n].make_batch(imgs[:n])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            by_size[n].predict_tensors(batch)
        torch.cuda.synchronize()
        need[n] = torch.cuda.max_memory_allocated() - base
        del batch
    batch8, _ = by_size[8].make_batch(imgs)
    plain = [by_size[2].predict_tensors(by_size[2].make_batch(imgs[i:i + 2])[0])
             for i in range(0, 8, 2)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    held = 3 * max(sum(t.numel() * t.element_size() for t in (*d, p) if torch.is_tensor(t))
                   for d, p in plain)
    window = need[4] - need[2] - held
    if window <= 0:
        raise AssertionError(f"oom_guard: no cap splits batch 4 from batch 2 "
                             f"(needs {need}, held outputs {held} bytes)")
    base = torch.cuda.memory_allocated()
    cap = base + need[2] + held + 3 * window // 4
    calls, failed = [], []

    def predict(batch):
        n = batch["images"].shape[0]
        calls.append(n)
        try:
            out = by_size[8].predict_tensors(batch)
            torch.cuda.synchronize()
            return out
        except torch.cuda.OutOfMemoryError:
            failed.append(n)
            raise

    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        dets, probs = oom_guard(predict)(batch8)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
        torch.cuda.empty_cache()
    if calls != [8, 4, 2, 2, 4, 2, 2] or failed != [8, 4, 4]:
        raise AssertionError(f"oom_guard: calls at batch {calls}, of which out of memory "
                             f"{failed}: expected 8 and 4 to fail and four 2s to run "
                             f"(cap {cap / 2**30:.3f} GiB over {base / 2**30:.3f} allocated; "
                             f"a predict allocates "
                             f"{ {n: round(v / 2**30, 3) for n, v in need.items()} } GiB, "
                             f"the guard holds {held / 2**30:.3f})")
    ref_dets = [torch.cat(xs) for xs in zip(*[d for d, _ in plain])]
    ref_probs = torch.cat([p for _, p in plain])
    for name, a, b in zip(dets._fields, dets, ref_dets):
        if not torch.equal(a, b):
            raise AssertionError(f"oom_guard: detections' {name} differ from four batch-2 "
                                 f"predicts (max |diff| {(a.float() - b.float()).abs().max()})")
    if not torch.equal(probs, ref_probs):
        raise AssertionError("oom_guard: mask probabilities differ from four batch-2 predicts")
    log(f"oom_guard: allocator capped at {cap / 2**30:.3f} GiB of {total / 2**30:.1f} "
        f"({base / 2**30:.3f} allocated before; a batch-2 predict allocates "
        f"{need[2] / 2**30:.3f} GiB at its peak, batch 4 {need[4] / 2**30:.3f}; the guard "
        f"holds up to {held / 2**30:.3f} of outputs): calls at batch {calls}, "
        f"torch.cuda.OutOfMemoryError at "
        f"{failed}; the halved run's {int(dets.valid.sum())} detections and mask "
        "probabilities equal four unguarded batch-2 predicts bit for bit; fraction restored")
    del plain, batch8, dets, probs


def serving_phase(kernels, config: str = CONFIG, device: str = "cuda",
                  buckets=SERVE_BUCKETS, small_sizes=SERVE_SMALL_SIZES, scene_hw=SCENE_HW,
                  patch: int = 1024) -> dict:
    """Phase 17 (see the module docstring). Returns the launch counts of the
    served round (path ``serve``)."""
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from rsprompter_tpu_torch.data.io import encode_png, imread
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa
    from rsprompter_tpu_torch.tools import image_demo, large_image_demo, serve
    from rsprompter_tpu_torch.tools import test as tool
    from rsprompter_tpu_torch.utils.large_image import slice_offsets

    t_phase = time.time()
    decode_ms = jpeg_fixture_check()
    jpegs = sorted(os.path.join(JPEG_DIR, n) for n in os.listdir(JPEG_DIR) if n.endswith(".jpg"))
    rng = np.random.default_rng(17)

    with tempfile.TemporaryDirectory() as tmp:
        # --- image_demo over the fixture directory
        t0 = time.time()
        out_dir = os.path.join(tmp, "demo")
        demo = image_demo.main([JPEG_DIR, config, "--out-dir", out_dir, "--score-thr", "0.0",
                                "--device", device])
        with open(os.path.join(out_dir, "predictions.json")) as f:
            dumped = json.load(f)
        if len(dumped) != len(jpegs) or len(demo["predictions"]) != len(jpegs):
            raise AssertionError(f"image_demo: {len(dumped)} entries for {len(jpegs)} images")
        for path in jpegs:  # drawn under the input's own name, JPEG at quality 95
            drawn = os.path.join(out_dir, os.path.basename(path))
            vis = imread(drawn)
            if vis.shape != imread(path).shape:
                raise AssertionError(f"image_demo: {drawn} is {vis.shape}")
        log(f"image_demo: {len(jpegs)} JPEGs -> {len(jpegs)} drawn JPEGs at the inputs' shapes "
            f"and predictions.json ({sum(len(p['scores']) for p in dumped)} detections) in "
            f"{time.time() - t0:.1f} s")
        del demo

        # --- the server, in-process, at a free port
        small = []
        for i, (h, w) in enumerate(small_sizes):
            cell = 24
            coarse = rng.uniform(0, 255, (h // cell + 1, w // cell + 1, 3))
            field = np.kron(coarse, np.ones((cell, cell, 1)))[:h, :w]
            img = np.clip(field + rng.normal(0, 10, field.shape), 0, 255).astype(np.uint8)
            small.append((os.path.join(tmp, f"small_{i}.png"), img))
            with open(small[-1][0], "wb") as f:
                f.write(encode_png(img))
        requests = []  # (kind, body, the image's path)
        for path in jpegs:
            with open(path, "rb") as f:
                requests.append(("jpeg bytes", f.read(), path))
        for path, img in small:
            requests.append(("png bytes", encode_png(img), path))
        for path in jpegs + [p for p, _ in small]:
            requests.append(("path", json.dumps({"path": path}).encode(), path))
        order = rng.permutation(len(requests))
        requests = [requests[i] for i in order]

        argv = [config, "--host", "127.0.0.1", "--port", "0", "--max-batch",
                str(SERVE_MAX_BATCH), "--size-buckets", ",".join(map(str, buckets)),
                "--warmup", "--batch-window-ms", "20", "--device", device]
        t0 = time.time()
        server = serve.make_server(argv)
        log(f"server ready in {time.time() - t0:.1f} s (build, weights check, warm-up of "
            f"{len(buckets)} buckets at batch {SERVE_MAX_BATCH}, smoke predict)")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        inferencer = server.inferencer
        det = inferencer.model
        window_batches = []  # kernel C's window calls: qkv's first dim (windows x slots)
        attention = fa.relpos_attention

        def recording(qkv, fh, fw, hw):
            if tuple(hw) == (det.backbone.config.window_size,) * 2:
                window_batches.append(qkv.shape[0])
            return attention(qkv, fh, fw, hw)

        try:
            for k in kernels:
                k.reset_counts()
            fa.relpos_attention = recording
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                answers = list(pool.map(
                    lambda r: _post(url + "/predict?score_thr=0.0", r[1]), requests))
            wall8 = time.perf_counter() - t0
            fa.relpos_attention = attention
            counts = {k.name: dict(k.variant_launches) for k in kernels}
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            for (kind, _, path), (status, payload, _) in zip(requests, answers):
                if status != 200 or not {"bboxes", "scores", "labels", "masks_rle"} <= set(payload):
                    raise AssertionError(f"serve: {kind} {path}: HTTP {status} {str(payload)[:200]}")
            if health["images"] != len(requests) or health["batches"] >= len(requests):
                raise AssertionError(f"serve: /healthz {health} for {len(requests)} requests")
            by_bucket = {b[0]: w.batches_run for b, w in server.dispatcher._workers.items()}
            forwards = sum(by_bucket.values())
            want = expected_forward_launches(det, forwards)
            for name, w in want.items():
                if counts.get(name, {}) != (w if device == "cuda" else {}):
                    raise AssertionError(f"serve: {name} launches {counts.get(name)}, expected "
                                         f"{w} over {forwards} served forwards")
            grid = {b: b // det.backbone.config.patch_size for b in buckets}
            win = det.backbone.config.window_size
            n_win = {b: ((grid[b] + win - 1) // win) ** 2 for b in buckets}
            n_layers = det.backbone.config.num_hidden_layers - len(
                det.backbone.config.global_attn_indexes)
            want_windows = sorted(x for b in buckets for x in
                                  [n_win[b] * SERVE_MAX_BATCH] * (n_layers * by_bucket.get(b, 0)))
            if sorted(window_batches) != want_windows:
                raise AssertionError(f"serve: kernel C's window calls took "
                                     f"{sorted(window_batches)} windows, expected "
                                     f"{want_windows} ({n_win} an image, {by_bucket} forwards)")
            log(f"serve: {len(requests)} POSTs (JPEG bytes, PNG bytes, paths) from "
                f"{SERVE_CLIENTS} clients, all 200; /healthz {health}; forwards by bucket "
                f"{by_bucket}; launches {counts} ({forwards} forwards x phase 3's); kernel C "
                f"windows an image {n_win}")
            log(latency_line(f"serve, concurrency {SERVE_CLIENTS}",
                             [a[2] for a in answers], wall8))
            scores = np.concatenate([np.asarray(a[1]["scores"], np.float64) for a in answers])
            # the large scene keeps the top tenth of what the served images scored
            # (random weights score every box low)
            scene_thr = float(np.quantile(scores, 0.9)) if scores.size else 0.0
            log(f"served scores: {scores.size} detections, quantiles 0.5 / 0.9 / 0.99 / max "
                f"{np.quantile(scores, [0.5, 0.9, 0.99, 1.0]).round(4).tolist() if scores.size else []}")

            # each answer against DetInferencer called directly at the same bucket
            worst = [0.0, 0.0, 0.0]
            n_dets = 0
            for (kind, _, path), (_, payload, _) in zip(requests, answers):
                direct = inferencer([path], score_thr=0.0)["predictions"][0]
                dists = served_vs_direct(payload, direct)
                worst = [max(a, b) for a, b in zip(worst, dists)]
                n_dets += len(payload["labels"])
            log(f"serve vs direct predict on the same images at the same bucket: "
                f"{n_dets} detections, labels and counts equal; worst |box diff| {worst[0]:.4g} "
                f"px (tol {SERVE_BOX_TOL}), |score diff| {worst[1]:.4g} (tol "
                f"{SERVE_SCORE_TOL}), share of mask pixels differing {worst[2]:.4g} (tol "
                f"{SERVE_MASK_TOL})")
            if (worst[0] > SERVE_BOX_TOL or worst[1] > SERVE_SCORE_TOL
                    or worst[2] > SERVE_MASK_TOL):
                raise AssertionError(f"serve: served answers differ from direct predicts {worst}")

            for path in (jpegs[0], small[0][0]):
                parts = [serve_breakdown(inferencer, path) for _ in range(3)]
                log(f"serve host breakdown, {os.path.basename(path)} alone (median of 3): "
                    + ", ".join(f"{k} {statistics.median(p[k] for p in parts):.2f}"
                                for k in parts[0]))

            # concurrency 1
            t0 = time.perf_counter()
            lat1 = []
            for _, body, _ in requests[:8]:
                status, _, sec = _post(url + "/predict?score_thr=0.0", body)
                if status != 200:
                    raise AssertionError(f"serve: HTTP {status} at concurrency 1")
                lat1.append(sec)
            log(latency_line("serve, concurrency 1", lat1, time.perf_counter() - t0))
        finally:
            fa.relpos_attention = attention
            server.shutdown()
            server.server_close()
            server.dispatcher.stop()
            thread.join(60)

        # --- oom_guard on a real CUDA out of memory
        if device == "cuda":
            big = [imread(p) for p in jpegs]
            big += [np.ascontiguousarray(np.flip(im, 1)) for im in big]
            oom_check(inferencer, big[:8])
        del server, inferencer, det

        # --- large_image_demo on a seeded scene
        t0 = time.time()
        h, w = scene_hw
        cell = 64
        coarse = rng.uniform(0, 255, (h // cell + 1, w // cell + 1, 3))
        scene = np.clip(np.kron(coarse, np.ones((cell, cell, 1)))[:h, :w]
                        + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
        scene_path = os.path.join(tmp, "scene.png")
        with open(scene_path, "wb") as f:
            f.write(encode_png(scene))
        large_dir = os.path.join(tmp, "large")
        res = large_image_demo.main([scene_path, config, "--out-dir", large_dir, "--patch",
                                     str(patch), "--overlap", "0.25", "--batch-size", "4",
                                     "--score-thr", f"{scene_thr:.6f}", "--device", device])
        offsets = slice_offsets(h, w, patch, 0.25)
        merged = res["merged"]
        if len(res["patch_predictions"]) != len(offsets):
            raise AssertionError(f"large_image_demo: {len(res['patch_predictions'])} patches, "
                                 f"slice_offsets gives {len(offsets)}")
        boxes = np.asarray(merged["bboxes"]).reshape(-1, 4)
        if len(boxes) and (boxes.min() < 0 or boxes[:, [0, 2]].max() > w
                           or boxes[:, [1, 3]].max() > h):
            raise AssertionError("large_image_demo: merged boxes outside the scene")
        drawn = imread(res["image_path"])
        with open(res["json_path"]) as f:
            dumped = json.load(f)
        if drawn.shape != scene.shape or len(dumped["scores"]) != len(boxes):
            raise AssertionError(f"large_image_demo: drawn {drawn.shape}, "
                                 f"{len(dumped['scores'])} dumped of {len(boxes)}")
        log(f"large_image_demo: {w}x{h} scene, {len(offsets)} patches of {patch}^2 (overlap "
            f"0.25, batch 4), {sum(len(p['scores']) for p in res['patch_predictions'])} patch "
            f"detections over score {scene_thr:.4f} -> {len(boxes)} merged, inside the "
            f"scene; drawn PNG and "
            f"predictions.json written; {time.time() - t0:.1f} s")
        del res

        # --- tools.test over the JPEG fixtures as a COCO set
        t0 = time.time()
        coco = jpeg_coco(os.path.join(tmp, "coco"))
        report = tool.main([config, "--device", device, "--cfg-options",
                            f"test_dataloader.dataset.data_root={coco}",
                            "test_dataloader.dataset.ann_file=ann.json",
                            "test_dataloader.dataset.data_prefix.img=imgs"])
        metrics = report["metrics"]
        bad = [k for k in JAX_TOOL_KEYS if not np.isfinite(metrics.get(k, float("nan")))]
        if bad:
            raise AssertionError(f"tools.test over JPEGs: keys missing or not finite: {bad}")
        if sys.modules.get("cv2") is not None:
            raise AssertionError("phase 17 imported cv2")
        log(f"tools.test over {report['timing']['images']} JPEGs (COCO GT written here): every "
            f"key of JAX's tool finite; {time.time() - t0:.1f} s")
        del report
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 17: {time.time() - t_phase:.1f} s; JPEG decode "
        f"{statistics.median(decode_ms.values()):.2f} ms an image (median)")
    return counts


# ---------------------------------------------------------------------------
# phase 18: the test tool's evaluation options, validation drawing and the
# analysis tools
# ---------------------------------------------------------------------------

TTA_PATH = "tta_predict"
CORRUPTION_RUNS = ("jpeg_compression", "motion_blur", "gaussian_noise")
# detections an image in phase 18's evaluation runs: the metric's host work
# (masks at the original size, RLE) follows them, 3.5 s an image at 100
TOOL_MAX_PER_IMG = 20
CORRUPTION_SEVERITY = 3
ENCODE_QUALITIES = (95, 7)


def jpeg_encoder_check(reps: int = 3) -> dict:
    """The port's JPEG encoder, built by g++ on this machine: its bytes of
    every fixture's decoded image at qualities 95 and 7 equal to
    ``cv2.imencode``'s (the sha256 in ``tests/data/jpeg/encode_digests.json``),
    each file decoding through the port's decoder to the image's shape.
    Returns {name: host ms an encode at quality 95 (median)}."""
    import hashlib

    from rsprompter_tpu_torch.data.io import imread
    from rsprompter_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, load_encoder

    t0 = time.time()
    load_encoder()
    log(f"JPEG encoder built and loaded in {time.time() - t0:.2f} s")
    with open(os.path.join(JPEG_DIR, "encode_digests.json")) as f:
        digests = json.load(f)
    ms = {}
    for name, want in sorted(digests.items()):
        img = imread(os.path.join(JPEG_DIR, name))
        for q in ENCODE_QUALITIES:
            times = []
            for _ in range(reps):
                t1 = time.perf_counter()
                data = encode_jpeg(img, q)
                times.append((time.perf_counter() - t1) * 1e3)
            got = hashlib.sha256(data).hexdigest()
            if got != want[str(q)]["sha256"]:
                raise AssertionError(f"JPEG encoder: {name} at quality {q}: sha256 {got[:16]}..., "
                                     f"cv2.imencode gave {want[str(q)]['sha256'][:16]}...")
            if decode_jpeg(data).shape != img.shape:
                raise AssertionError(f"JPEG encoder: {name} at quality {q} decodes to another "
                                     "shape")
            if q == 95:
                ms[name] = statistics.median(times)
    log("JPEG encoder: every fixture at qualities 95 and 7 gives cv2.imencode's bytes and "
        "decodes to its shape; host ms an encode at 95 (median of "
        f"{reps}): " + ", ".join(f"{n} {v:.2f}" for n, v in ms.items()))
    return ms


def tta_layer_rows(layer, x, with_mlp: bool) -> list:
    """Phase 3's rows of B and C (and A where ``with_mlp``) on the inputs that
    ``layer`` of the encoder gives them for the layer input ``x`` (B, H, W, C)
    bf16."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops.attention import rel_pos_factors

    attn, win, eps = layer.attn, layer.window_size, layer.eps
    bsz, grid, _, c = x.shape
    nh, kind = attn.num_heads, "window" if win else "global"
    ln1, ln2, mlp = layer.layer_norm1, layer.layer_norm2, layer.mlp
    b_in = (x, ln1.weight, ln1.bias, attn.qkv.weight.to(x.dtype), layer._qkv_bias(x), eps)
    rows = qkv_rows(None, None, bsz, grid, c, nh, win, "@tta", b_in, (kind,))
    qkv = fm.ln_qkv_headmajor(*b_in[:5], 3 * nh, win, eps)
    hw = (win, win) if win else (grid, grid)
    fh, fw = rel_pos_factors(qkv[:, :nh], attn.rel_pos_h, attn.rel_pos_w, hw)
    rows += attention_rows(None, bsz, grid, nh, c // nh, win or grid, "@tta",
                           (qkv, fh.contiguous(), fw.contiguous()), (kind,))
    if with_mlp:
        x2 = (x + layer._attend(qkv, x.shape[:3], False)).reshape(-1, c).contiguous()
        dt = x.dtype
        rows.append(mlp_row(None, None, x2.shape[0], c, "@tta", inputs=(
            x2, ln2.weight, ln2.bias, mlp.lin1.weight.to(dt), mlp.lin1.bias.to(dt),
            mlp.lin2.weight.to(dt), mlp.lin2.bias.to(dt), eps)))
    return rows


def tta_kernel_rows(det, batch) -> list:
    """Kernels A, B and C against their plain versions on the inputs that the
    mirrored batch gives the encoder's first window layer and its first
    global layer (path ``tta_predict``)."""
    import torch

    from rsprompter_tpu_torch.models.preprocess import preprocess_images
    from rsprompter_tpu_torch.models.tta import hflip_batch

    enc = det.backbone
    rows, seen = [], set()
    with torch.no_grad():
        x = enc.patch_embed(preprocess_images(hflip_batch(batch)["images"]))
        if enc.pos_embed is not None:
            x = x + enc.pos_embed.to(x.dtype)
        x = x.to(torch.bfloat16)
        for layer in enc.layers:
            kind = "window" if layer.window_size else "global"
            if kind not in seen:
                rows += tta_layer_rows(layer, x.contiguous(), with_mlp=not seen)
                seen.add(kind)
            if len(seen) == 2:
                break
            x = layer(x, "kernel")
    for r in rows:
        r["path"] = TTA_PATH
    log_rows(rows)
    return rows


def check_tool_keys(what: str, metrics: dict) -> None:
    import numpy as np

    bad = [k for k in JAX_TOOL_KEYS if not np.isfinite(metrics.get(k, float("nan")))]
    if bad:
        raise AssertionError(f"{what}: keys missing or not finite: {bad}")


def corruption_host_ms(img) -> dict:
    """Host ms of each corruption at ``CORRUPTION_SEVERITY`` on one image
    (float32, as the test tool's pipeline hands it over)."""
    import numpy as np

    from rsprompter_tpu_torch.data.corruptions import CORRUPTIONS, corrupt

    x = img.astype(np.float32)
    ms = {}
    for name in CORRUPTIONS:
        t0 = time.perf_counter()
        out = corrupt(x, name, CORRUPTION_SEVERITY, seed=1)
        ms[name] = (time.perf_counter() - t0) * 1e3
        if out.shape != x.shape or not np.isfinite(out).all():
            raise AssertionError(f"corruption {name}: {out.shape}, or not finite")
    return ms


def tta_tools_phase(kernels, config: str = CONFIG, device: str = "cuda",
                    eval_sizes=EVAL_SIZES, vis_config: str = TRAIN_CONFIG,
                    tool_config: Optional[str] = None) -> tuple:
    """Phase 18 (see the module docstring). Returns (the launch counts of one
    TTA batch, path ``tta_predict``; the kernel rows held on that path).
    ``tool_config`` is what ``benchmark`` and ``get_flops`` run on
    (default ``config``)."""
    import tempfile

    import numpy as np
    import torch

    from rsprompter_tpu_torch.apis.inference import init_detector
    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.core.registry import DATASETS
    from rsprompter_tpu_torch.data.io import imread
    from rsprompter_tpu_torch.data.loader import DataLoader
    from rsprompter_tpu_torch.engine.runner import Runner
    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.models.tta import (hflip_batch, make_tta_predict, merge_views,
                                                 tta_settings)
    from rsprompter_tpu_torch.tools import test as tool
    from rsprompter_tpu_torch.tools.analysis_tools import benchmark, get_flops
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t_phase = time.time()
    on_card = device == "cuda"
    encode_ms = jpeg_encoder_check()

    # --- (b) TTA: launches, the hand merge, the kernels at the mirrored batch
    inferencer = init_detector(config, device=device, batch_size=2, seed=0)
    det = inferencer.model
    settings = tta_settings(inferencer.cfg)
    paste = inferencer.mask_mode == "paste"
    tta = make_tta_predict(det, **settings)
    batch, metas = inferencer.make_batch(synthetic_images(0))
    widths = batch["img_shape"][:, 1].tolist()
    if min(widths) == batch["images"].shape[2]:
        raise AssertionError(f"TTA: no image narrower than the canvas ({widths})")
    tta(batch)  # warm-up
    for k in kernels:
        k.reset_counts()
    dets, probs = tta(batch)
    if on_card:
        torch.cuda.synchronize()
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    if kernels:
        want = expected_forward_launches(det, 2)
        for name, w in want.items():
            if counts[name] != w:
                raise AssertionError(f"TTA {name}: launches {counts[name]}, expected {w} "
                                     "(twice phase 3's per forward)")
    hand = merge_views(batch, det.predict(batch), det.predict(hflip_batch(batch)),
                       paste=paste, **settings)
    for field, a, b in zip(dets._fields + ("probs",), tuple(dets) + (probs,),
                           tuple(hand[0]) + (hand[1],)):
        if not torch.equal(a, b):
            raise AssertionError(f"TTA {field}: not the merge of two predicts, bit for bit")
    n_kept = dets.valid.sum(1).tolist()
    if min(n_kept) == 0 or not torch.isfinite(dets.scores).all():
        raise AssertionError(f"TTA: kept {n_kept}, or scores not finite")
    log(f"TTA predict ({settings}): launches {counts}; equal bit for bit to merge_views of two "
        f"model.predict calls; kept {n_kept} of {dets.valid.shape[1]}; valid widths {widths}")
    rows = []
    if on_card:
        tta_ms = cuda_time_ms(lambda: tta(batch), warmup=1, iters=5, repeat=2)
        plain_ms = cuda_time_ms(lambda: det.predict(batch), warmup=1, iters=5, repeat=2)
        log(f"TTA: {tta_ms:.2f} ms a batch of 2 ({2e3 / tta_ms:.3f} images/s) against plain "
            f"predict {plain_ms:.2f} ms ({2e3 / plain_ms:.3f} images/s), {tta_ms / plain_ms:.3f}x "
            "(CUDA events, median of 5 runs of 2 back-to-back calls)")
        rows = tta_kernel_rows(det, batch)
    del inferencer, det, tta, dets, probs, hand
    if on_card:
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # --- tools.test --tta over phase 9's synthetic PNG set
        t0 = time.time()
        png = synthetic_coco(os.path.join(tmp, "png"), NWPU_CLASSES, eval_sizes, write_png,
                             seed=0)
        where = ["--cfg-options", "test_dataloader.dataset.ann_file=ann.json",
                 "test_dataloader.dataset.data_prefix.img=imgs",
                 f"model.test_cfg.rcnn.max_per_img={TOOL_MAX_PER_IMG}"]
        for k in kernels:
            k.reset_counts()
        report = tool.main([config, "--tta", "--device", device] + where
                           + [f"test_dataloader.dataset.data_root={png}"])
        tool_counts = {k.name: dict(k.variant_launches) for k in kernels}
        n_batches = -(-len(eval_sizes) // report["inferencer"].batch_size)
        if kernels:
            want = expected_forward_launches(report["inferencer"].model, 2 * n_batches)
            for name, w in want.items():
                if tool_counts[name] != w:
                    raise AssertionError(f"tools.test --tta {name}: launches "
                                         f"{tool_counts[name]}, expected {w}")
        check_tool_keys("tools.test --tta", report["metrics"])
        timing = report["timing"]
        log(f"tools.test --tta over {timing['images']} PNGs: every key of JAX's tool finite, "
            f"A, B, C launched twice a forward's count for each of {n_batches} batches; "
            f"{timing['images'] / timing['wall_s']:.3f} images/s, predict "
            f"{timing['predict_s']:.3f} s; {time.time() - t0:.1f} s")
        del report

        # --- (c) corruptions over the JPEG fixtures; --show-dir on one run
        t0 = time.time()
        coco = jpeg_coco(os.path.join(tmp, "jpeg"))
        names = sorted(n for n in os.listdir(os.path.join(coco, "imgs")) if n.endswith(".jpg"))
        host_ms = corruption_host_ms(imread(os.path.join(coco, "imgs", names[0])))
        log(f"corruptions at severity {CORRUPTION_SEVERITY}, host ms on {names[0]}: "
            + ", ".join(f"{k} {v:.1f}" for k, v in host_ms.items()))
        show = os.path.join(tmp, "show")
        for name in CORRUPTION_RUNS:
            argv = [config, "--corruption", name, "--severity", str(CORRUPTION_SEVERITY),
                    "--device", device] + where + [f"test_dataloader.dataset.data_root={coco}"]
            if name == CORRUPTION_RUNS[0]:
                argv += ["--show-dir", show]
            report = tool.main(argv)
            check_tool_keys(f"tools.test --corruption {name}", report["metrics"])
            log(f"tools.test --corruption {name} --severity {CORRUPTION_SEVERITY}: bbox_mAP "
                f"{report['metrics']['coco/bbox_mAP']}, segm_mAP "
                f"{report['metrics']['coco/segm_mAP']}, drawing {report['timing']['visit_s']:.3f} s")
            del report
        if sorted(os.listdir(show)) != names:
            raise AssertionError(f"--show-dir wrote {sorted(os.listdir(show))}, not {names}")
        for name in names:
            with open(os.path.join(show, name), "rb") as f:
                if f.read(2) != b"\xff\xd8":
                    raise AssertionError(f"--show-dir {name}: not a JPEG")
            if imread(os.path.join(show, name)).shape != imread(
                    os.path.join(coco, "imgs", name)).shape:
                raise AssertionError(f"--show-dir {name}: not the image's size")
        log(f"--show-dir: {len(names)} JPEGs under the images' names at their sizes; "
            f"(c) in {time.time() - t0:.1f} s")

        # --- (d) Runner.validate() with vis_interval=1
        t0 = time.time()
        vis_cfg = Config.fromfile(vis_config)
        vis_cfg.merge_from_options([f"model.test_cfg.rcnn.max_per_img={TOOL_MAX_PER_IMG}"])
        trainer = build_trainer(vis_cfg, device=device, seed=0)
        val = DataLoader(DATASETS.build(dict(type="NWPUInsSegDataset", data_root=coco,
                                             ann_file="ann.json", data_prefix=dict(img="imgs"),
                                             test_mode=True)), batch_size=2)
        work = os.path.join(tmp, "work")
        results = Runner(trainer, None, val, work_dir=work, num_classes=len(NWPU_CLASSES),
                         vis_interval=1).validate()
        drawn = sorted(os.listdir(os.path.join(work, "vis")))
        if drawn != ["val_0.jpg", "val_2.jpg"]:
            raise AssertionError(f"Runner vis_interval=1 drew {drawn}")
        shape = imread(os.path.join(work, "vis", "val_0.jpg")).shape
        if shape != imread(os.path.join(coco, "imgs", names[0])).shape:
            raise AssertionError(f"vis/val_0.jpg is {shape}")
        check_tool_keys("Runner.validate", results)
        log(f"Runner.validate with vis_interval=1: {drawn} at the images' sizes; "
            f"{time.time() - t0:.1f} s")
        del trainer
    if on_card:
        torch.cuda.empty_cache()

    # --- (e) the analysis tools on the card
    t0 = time.time()
    bench = benchmark.main([tool_config or config, "--task", "inference", "--batch-size", "2",
                            "--repeat", "10", "--device", device])
    t1 = time.time()
    flops = get_flops.main([tool_config or config, "--device", device])
    log(f"benchmark --task inference: {bench['images_per_s']:.3f} images/s "
        f"({bench['ms_per_batch']:.2f} ms a batch of 2) on {bench['device']} in "
        f"{t1 - t0:.1f} s; get_flops (predict, 1 x {flops['input'][1:]}): "
        f"{flops['flops'] / 1e9:.2f} GFLOPs of products and convolutions, "
        f"{flops['params'] / 1e6:.2f} M parameters, counted on {device} (the encoder's plain "
        f"route, fp32) in {time.time() - t1:.1f} s")
    if sys.modules.get("cv2") is not None:
        raise AssertionError("phase 18 imported cv2")
    log(f"phase 18: {time.time() - t_phase:.1f} s; JPEG encode "
        f"{statistics.median(encode_ms.values()):.2f} ms an image at quality 95 (median)")
    return counts, rows


# ---------------------------------------------------------------------------
# phase 19: data parallelism and mode='tensor'
# ---------------------------------------------------------------------------

DP_RANKS = 2  # on card 0, over gloo: NCCL refuses two ranks on one card
DP_BATCH = 2  # images a rank: the scratch-512 config's batch of 4 over two ranks
DP_STEPS = 3
DP_PATH, TENSOR_PATH = "dp_train_step", "tensor_mode"
DP_LOSS_TOL = 1e-2  # relative: the losses and grad_norm, world 2 against one process
DP_GRAD_TOL = 2e-2  # of each trained tensor's largest gradient ...
DP_GRAD_MEDIAN_TOL = 1e-3  # ... at the median tensor
DP_STATS_TOL = 1e-3  # BatchNorm's statistics after the first step
DP_METRIC_TOL = 1e-3  # torchrun's tools.test against phase 9's metrics
DDP_TIMED_STEPS = 5  # each way, twice, in turns
TORCHRUN_TIMEOUT_S = 600


def _held_proposals(proposals, rows: slice):
    """An ``rpn_predict`` that returns ``proposals``' rows: the train step's
    proposals held to the ones given (phase 6 holds its runs' alike)."""
    from rsprompter_tpu_torch.models.dense_heads.rpn_head import Proposals

    def held(*_args, **_kwargs):
        return Proposals(*(t[rows] for t in proposals))

    return held


def _dp_rank(config: str, batch_np, ref_path: str, steps: int, device: str, eval_args):
    """One rank of phase 19(a) (spawned by ``parallel.launch``, on card 0
    over gloo): ``build_trainer`` on its rows of the global batch, ``steps``
    steps from the generator's seeds 0, 1, ...; the first with the one
    process's proposals (its rows of them, from ``ref_path``). After the
    first step, ``Trainer.state_dict()`` (a collective: ZeRO's moments
    gathered from their owners) and, on rank 0, each trained tensor's
    gradient and gathered moments against the one process's; every rank
    sends digests of the moments it owns, which the gathered ones must
    equal. After the last step, ``tools.test`` on phase 9's set and
    checkpoint (``eval_args``), each rank its block of the set. Returns the
    first step's global metrics, its launches, its BatchNorm statistics,
    those ratios, the step times, the launches over every step, the
    parameters that differ from rank 0's after the last step and the
    sharded evaluation's metrics and image count."""
    import torch
    import torch.distributed as dist

    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.models.dense_heads import rpn_head as rpn_mod
    from rsprompter_tpu_torch.ops import _cuda
    from rsprompter_tpu_torch.parallel import distributed
    from rsprompter_tpu_torch.tools import test as test_tool

    rank, world = distributed.rank(), distributed.world_size()
    on_card = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    kernels = _cuda.all_kernels()
    trainer = build_trainer(config, device=dev, seed=0, steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    b = batch_np["images"].shape[0] // world
    local = {k: torch.as_tensor(v[rank * b:(rank + 1) * b], device=dev)
             for k, v in batch_np.items()}
    gen = torch.Generator(device=dev)
    ref = torch.load(ref_path, map_location="cpu", weights_only=True)
    for k in kernels:
        k.reset_counts()
    rpn_predict = rpn_mod.rpn_predict
    rpn_mod.rpn_predict = _held_proposals(tuple(t.to(dev) for t in ref["proposals"]),
                                          slice(rank * b, (rank + 1) * b))
    try:
        metrics = trainer.step(local, gen.manual_seed(0))
    finally:
        rpn_mod.rpn_predict = rpn_predict
    sync()
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               counts={k.name: dict(k.variant_launches) for k in kernels},
               stats={k: v.float().cpu().clone() for k, v in trainer.model.state_dict().items()
                      if "running" in k})
    names = [n for n, _ in trainer.optimizer.trained]
    if rank == 0:
        out["grad_ratios"] = relative_grad_diffs(
            {n: p.grad.float().cpu() for n, p in trainer.optimizer.trained}, ref["grads"])
    state = trainer.state_dict()["optimizer"]["adamw"]  # every rank: a collective
    local_state = trainer.optimizer.adamw.optim.state
    owned = {i: [_digest(local_state[p][k]) for k in ("exp_avg", "exp_avg_sq")]
             for i, (_, p) in enumerate(trainer.optimizer.trained) if p in local_state}
    out["owned"] = len(owned)
    owned_all = distributed.all_gather_object(owned)
    if rank == 0:
        gathered = state["state"]
        out["moments"] = dict(
            n=len(gathered), trained=len(names),
            steps=sorted({float(v["step"]) for v in gathered.values()}),
            owners=[len(o) for o in owned_all],
            unequal=[i for o in owned_all for i, d in o.items()
                     if d != [_digest(gathered[i][k]) for k in ("exp_avg", "exp_avg_sq")]],
            avg_ratios=relative_grad_diffs(
                {n: gathered[i]["exp_avg"] for i, n in enumerate(names)}, ref["exp_avg"]),
            sq_ratios=relative_grad_diffs(
                {n: gathered[i]["exp_avg_sq"].sqrt() for i, n in enumerate(names)},
                {n: v.sqrt() for n, v in ref["exp_avg_sq"].items()}))
    del ref, state
    times = []
    for i in range(1, steps):
        t0 = time.perf_counter()
        trainer.step(local, gen.manual_seed(i))
        sync()
        times.append(time.perf_counter() - t0)
    out["counts_all"] = {k.name: dict(k.variant_launches) for k in kernels}
    unequal = []
    for n, p in trainer.model.named_parameters():  # rank 0's, sent to every rank
        t = p.detach().clone()
        dist.broadcast(t, 0)
        if not torch.equal(t, p.detach()):
            unequal.append(n)
    out.update(unequal=unequal, step_s=times)
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    eval_root, ckpt_path, eval_config = eval_args
    report = test_tool.main([eval_config, ckpt_path, "--device", device,
                             "--cfg-options", *_eval_options(eval_root)])
    out["eval"] = dict(metrics=report["metrics"], digest=report["digest"],
                       images=report["timing"]["images"])
    return out


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().float().contiguous().cpu().numpy().tobytes()).hexdigest()


def write_eval_set(root: str, config: str = CONFIG):
    """Phase 9's evaluation set (synthetic PNGs, seed 0) and checkpoint
    (seed 1) under ``root``: (data root, checkpoint path)."""
    import torch

    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    data = synthetic_coco(os.path.join(root, "eval"), NWPU_CLASSES, EVAL_SIZES, write_png,
                          seed=0)
    _, ckpt = reference_state_dict(Config.fromfile(config)["model"], seed=1)
    path = os.path.join(root, "epoch_12.pth")
    torch.save(ckpt, path)
    return data, path


def _eval_options(data_root: str) -> list:
    return [f"test_dataloader.dataset.data_root={data_root}",
            "test_dataloader.dataset.ann_file=ann.json",
            "test_dataloader.dataset.data_prefix.img=imgs"]


def _dp_batch(cfg, images: int):
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    return synthetic_batch(images, tuple(cfg["crop_size"]), cfg["model"]["num_classes"],
                           max_gt=8, seed=0)


def dp_gate(what: str, ratios: dict, floor: Optional[dict]) -> Optional[str]:
    """Phase 19(a)'s rule for per-tensor distances from the one process
    (``relative_grad_diffs``): the fixed limits (``DP_GRAD_TOL`` at the
    worst tensor, ``DP_GRAD_MEDIAN_TOL`` at the median), or else phase 6's
    rule against the bf16 noise ``floor``. Returns the fault, or None."""
    worst = max(ratios, key=ratios.get)
    med = statistics.median(ratios.values())
    fixed = ratios[worst] <= DP_GRAD_TOL and med <= DP_GRAD_MEDIAN_TOL
    check_grads(what, ratios, None)
    log(f"{what}: gate {'fixed' if fixed else 'noise floor'} (worst {ratios[worst]:.4g} "
        f"against {DP_GRAD_TOL}, median {med:.4g} against {DP_GRAD_MEDIAN_TOL})")
    if fixed:
        return None
    if floor is None:
        return (f"{what}: {worst} {ratios[worst]:.4g} > {DP_GRAD_TOL} or median {med:.4g} > "
                f"{DP_GRAD_MEDIAN_TOL}")
    try:
        check_floor(what, ratios, floor)
    except AssertionError as err:
        return str(err)
    return None


def dp_phase(kernels, evaluation: dict, config: str = TRAIN_CONFIG,
             eval_config: str = CONFIG, device: str = "cuda", ranks: int = DP_RANKS,
             steps: int = DP_STEPS) -> dict:
    """Phase 19(a). The scratch-512 step at world ``ranks`` (spawned ranks
    on card 0, gloo, ZeRO on, the config's per-device batch split over
    them) against one process on the whole batch from the same weights,
    draws and proposals (phase 6's reason: bf16 noise reorders the near
    ties of a random RPN's top-k, and the runs would sample other RoIs):
    the metrics, every trained gradient and AdamW's moments after the step
    (ZeRO's, gathered by ``Trainer.state_dict()``), BatchNorm's statistics,
    the parameters on every rank after ``steps`` steps, the launches; then
    the ranks' sharded ``tools.test`` against phase 9's metrics and its
    digest (``evaluation``; on random weights every mAP is 0, and the
    detections' count and mean score and mask probability are what tell
    one prediction from another): the ranks' blocks of the set make the
    batches phase 9 made. Returns rank 0's launches over its steps."""
    import tempfile

    import torch

    from rsprompter_tpu_torch.engine.train_state import build_trainer
    from rsprompter_tpu_torch.models.dense_heads import rpn_head as rpn_mod
    from rsprompter_tpu_torch.parallel import launch

    t_phase = time.time()
    on_card = device == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ref = build_trainer(config, device=dev, seed=0, steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
    cfg, opt = ref.cfg, ref.optimizer
    bsz = cfg["train_dataloader"]["batch_size"]
    batch_np = _dp_batch(cfg, bsz)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
    gen = torch.Generator(device=dev)
    start = {k: v.clone() for k, v in ref.model.state_dict().items()}
    rpn_predict, kept = rpn_mod.rpn_predict, []

    def keep_first(*a, **kw):
        if not kept:
            kept.append(rpn_predict(*a, **kw))
        return kept[0]

    def one_step():  # from the same start and a fresh AdamW
        ref.model.load_state_dict(start)
        opt.adamw.state.clear()
        rpn_mod.rpn_predict = keep_first
        try:
            m = ref.step(batch, gen.manual_seed(0))
        finally:
            rpn_mod.rpn_predict = rpn_predict
        sync()
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.float().cpu() for n, p in opt.trained},
                {k: v.float().cpu().clone() for k, v in ref.model.state_dict().items()
                 if "running" in k},
                {k: {n: opt.adamw.state[p][k].float().cpu() for n, p in opt.trained}
                 for k in ("exp_avg", "exp_avg_sq")})

    metrics, grads, stats, moments = one_step()
    _, again, _, _ = one_step()  # the one process's own spread
    spread = relative_grad_diffs(again, grads)
    floor = None
    if on_card:  # phase 6's floor on the one process's batch, weights, draws and proposals
        ref.model.load_state_dict(start)

        def loss_fn():
            return ref.model(batch, mode="loss", generator=gen.manual_seed(0))

        rpn_mod.rpn_predict = keep_first
        try:
            plain, fp32, _, _ = CutLossRuns(ref.model, opt, loss_fn).noise_floor()
        finally:
            rpn_mod.rpn_predict = rpn_predict
        zero = {n: torch.zeros_like(g) for n, g in grads.items()}  # unreached: zero
        floor = relative_grad_diffs({n: plain.get(n, zero[n]).cpu() for n in grads},
                                    {n: fp32.get(n, zero[n]).cpu() for n in grads})
        check_grads("plain bf16 against the fp32-encoder step (the floor)", floor, None)
        del plain, fp32, zero
    ref.optimizer.zero_grad()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"grads": grads, "proposals": tuple(t.cpu() for t in kept[0]), **moments},
                   ref_path)
        del moments
        eval_args = (*write_eval_set(tmp, eval_config), eval_config)
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.time()
        res = launch.run_ranks(_dp_rank, ranks,
                               (config, batch_np, ref_path, steps, device, eval_args),
                               device="cuda:0" if on_card else "cpu", backend="gloo",
                               timeout_s=900)
        wall = time.time() - t0

    r0, faults = res[0], []
    # losses and grad_norm: the ranks' means are the global batch's
    bad = {k: (r0["metrics"][k], v) for k, v in metrics.items()
           if abs(r0["metrics"][k] - v) > DP_LOSS_TOL * max(abs(v), 1e-4)}
    if bad or r0["metrics"].keys() != metrics.keys():
        faults.append(f"metrics differ from one process: {bad}")
    log(f"data parallel, {ranks} ranks on card 0 over gloo, ZeRO on, {bsz // ranks} images a "
        f"rank, against one process on the {bsz} (the same weights, draws and proposals): "
        f"metrics {json.dumps(r0['metrics'])}; one process {json.dumps(metrics)}")
    check_grads("one process against itself, the same step twice", spread, None)
    # every trained tensor's gradient, then AdamW's moments after the step
    mom = r0["moments"]
    for what, ratios in (("data parallel gradients against one process", r0["grad_ratios"]),
                         ("gathered exp_avg against one process's AdamW", mom["avg_ratios"]),
                         ("gathered sqrt(exp_avg_sq) against one process's AdamW",
                          mom["sq_ratios"])):
        fault = dp_gate(what, ratios, floor)
        if fault:
            faults.append(fault)
    if (mom["n"] != mom["trained"] or mom["steps"] != [1.0] or mom["unequal"]
            or sum(mom["owners"]) != mom["trained"] or min(mom["owners"]) == 0):
        faults.append(f"ZeRO's gathered moments: {mom['n']} of {mom['trained']} tensors, steps "
                      f"{mom['steps']}, owned {mom['owners']}, differing from their owner's "
                      f"{mom['unequal'][:3]}")
    log(f"ZeRO: the ranks own {mom['owners']} of {mom['trained']} trained tensors' moments; "
        f"Trainer.state_dict() gathered all {mom['n']} to rank 0, each equal bit for bit to "
        f"its owner's, step {mom['steps']}")
    # BatchNorm statistics: the global batch's, equal on every rank
    worst_bn = 0.0
    for r, rr in enumerate(res):
        for k, v in stats.items():
            diff = (rr["stats"][k] - v).abs().max().item()
            worst_bn = max(worst_bn, diff / max(v.abs().max().item(), 1.0))
            if not torch.allclose(rr["stats"][k], v, rtol=DP_STATS_TOL, atol=DP_STATS_TOL):
                faults.append(f"rank {r} BN {k} off by {diff:.3e}, its largest "
                              f"{v.abs().max().item():.3e}")
            if not torch.equal(rr["stats"][k], r0["stats"][k]):
                faults.append(f"BN {k} differs between ranks")
        if rr["unequal"]:
            faults.append(f"rank {r}'s parameters differ from rank 0's after {steps} steps: "
                          f"{rr['unequal'][:3]}")
        if on_card:
            try:
                check_train_launches(f"data parallel rank {r}", rr["counts"], ref.model, 1)
            except AssertionError as err:
                faults.append(str(err))
        # the sharded evaluation: phase 9's metrics, every image once
        ev = rr["eval"]
        differ = {k: (ev["metrics"].get(k), v) for k, v in evaluation["metrics"].items()
                  if not (k in ev["metrics"] and metric_close(ev["metrics"][k], v))}
        differ.update({k: (ev["digest"].get(k), v) for k, v in evaluation["digest"].items()
                       if not (k in ev["digest"] and metric_close(ev["digest"][k], v))})
        if (differ or ev["images"] != len(EVAL_SIZES)
                or ev["digest"]["val/num_dets"] != evaluation["digest"]["val/num_dets"]):
            faults.append(f"rank {r}'s sharded tools.test: {ev['images']} images; against "
                          f"phase 9: {differ}")
    step_ms = [round(s * 1e3, 2) for s in r0["step_s"]]
    log(f"data parallel: {len(stats)} BN statistics within {worst_bn:.3e} (relative, over 1) "
        f"of one process's, equal on every rank: {not any('BN' in f for f in faults)}; "
        f"parameters equal on every rank after {steps} steps: "
        f"{not any('parameters' in f for f in faults)}; rank 0's launches over its steps "
        f"{r0['counts_all']}; steps 2..{steps} {step_ms} ms a rank; {wall:.1f} s for the "
        f"ranks (spawn, build, steps, evaluation)")
    log(f"data parallel tools.test, {ranks} ranks on card 0 over gloo, phase 9's set and "
        f"checkpoint: {r0['eval']['images']} images, each once; every metric within "
        f"{DP_METRIC_TOL} of phase 9's: {not any('tools.test' in f for f in faults)}; "
        + json.dumps({**r0["eval"]["metrics"], **r0["eval"]["digest"]}) + "; phase 9's digest "
        + json.dumps(evaluation["digest"]))
    if faults:
        raise AssertionError("data parallel: " + "; ".join(faults))
    del ref, start, batch
    if on_card:
        torch.cuda.empty_cache()
    log(f"phase 19(a): {time.time() - t_phase:.1f} s")
    return r0["counts_all"]


def metric_close(got: float, want: float) -> bool:
    import math

    return abs(got - want) <= DP_METRIC_TOL or (math.isnan(want) and math.isnan(got))


def ddp_overhead(config: str = TRAIN_CONFIG, device: str = "cuda",
                 iters: int = DDP_TIMED_STEPS) -> None:
    """Phase 19: the step at world 1 (a process group of one, NCCL on the
    card) without DDP, as ``Trainer`` takes it at world 1, against the same
    step through ``data_parallel`` (``find_unused_parameters``: a walk of
    the autograd graph every step) and through DDP with ``static_graph``
    (the unreached parameters found once), in turns; the bytes the
    step all-reduces (DDP's gradient buckets) and, at world N with ZeRO,
    broadcasts (the updated shards)."""
    import tempfile

    import torch

    from rsprompter_tpu_torch.engine.train_state import (build_trainer, data_parallel,
                                                         make_train_step)
    from rsprompter_tpu_torch.parallel import distributed

    on_card = device == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(dev, backend="nccl" if on_card else "gloo",
                               init_method=f"file://{os.path.join(tmp, 'init')}",
                               world_size=1, rank=0)
        try:
            steps = {}
            for name in ("plain", "find_unused", "static_graph"):
                tr = build_trainer(config, device=dev, seed=0,
                                   steps_per_epoch=TRAIN_STEPS_PER_EPOCH)
                if tr.ddp is not None:
                    raise AssertionError("DDP overhead: the trainer wrapped a world of one")
                if name == "plain":
                    model = tr.model
                elif name == "find_unused":
                    model = data_parallel(tr.model)
                else:
                    model = torch.nn.parallel.DistributedDataParallel(
                        tr.model, broadcast_buffers=False, static_graph=True)
                steps[name] = (tr, make_train_step(model, tr.optimizer))
            tr = steps["plain"][0]
            batch = {k: torch.as_tensor(v, device=dev) for k, v in _dp_batch(
                tr.cfg, tr.cfg["train_dataloader"]["batch_size"]).items()}
            gen = torch.Generator(device=dev)
            times = {name: [] for name in steps}
            for name in ("plain", "find_unused", "static_graph", "static_graph", "find_unused",
                         "plain"):
                step = steps[name][1]
                step(batch, gen.manual_seed(0))  # warm-up (static_graph's first step)
                sync()
                for i in range(iters):
                    t0 = time.perf_counter()
                    step(batch, gen.manual_seed(1 + i))
                    sync()
                    times[name].append((time.perf_counter() - t0) * 1e3)
            grad_bytes = sum(p.numel() * p.element_size() for p in tr.model.parameters()
                             if p.requires_grad)
            trained_bytes = sum(p.numel() * p.element_size() for _, p in tr.optimizer.trained)
        finally:
            distributed.shutdown()
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"DDP overhead, world 1 ({'NCCL' if on_card else 'gloo'}), scratch-512 step, batch "
        f"{batch['images'].shape[0]}, median of {2 * iters} steps each in turns: "
        f"{med['plain']:.2f} ms without DDP (the trainer's step at world 1), "
        f"{med['find_unused']:.2f} ms with DDP and find_unused_parameters "
        f"({med['find_unused'] / med['plain']:.4f}x), {med['static_graph']:.2f} ms with "
        f"static_graph ({med['static_graph'] / med['plain']:.4f}x); a step all-reduces "
        f"{grad_bytes / 1e6:.1f} MB of fp32 gradients (DDP's buckets) plus the metrics, the "
        f"loss normalisers and BatchNorm's sums; with ZeRO at world N it also broadcasts the "
        f"{trained_bytes / 1e6:.1f} MB of updated parameters, each from its shard's rank")
    del steps, tr
    if on_card:
        torch.cuda.empty_cache()


def _torchrun(module: str, args, nproc: int, what: str) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node N -m
    MODULE ARGS`` from the repository root; raises with its output's tail
    if it fails. Returns its standard output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", module, *args]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4")
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TORCHRUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {what}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
    log(f"torchrun {what}: {time.time() - t0:.1f} s")
    return proc.stdout


def torchrun_phase(eval_metrics: dict, config: str = TRAIN_CONFIG, eval_config: str = CONFIG,
                   device: str = "cuda", nproc: Optional[int] = None) -> None:
    """Phase 19(b). ``tools.train`` under torchrun, one rank a card (NCCL),
    on phase 11's synthetic set: two epochs, then a resumed third with a
    validation (sharded where there is more than one card); then
    ``tools.test`` under torchrun on phase 9's set and checkpoint, whose
    metrics must be phase 9's (``eval_metrics``) within ``DP_METRIC_TOL``,
    every image evaluated once. On one card this is world 1: the
    launcher's environment, ``initialize()`` and an NCCL group of one,
    with no collective to run (phase 19(a) runs them)."""
    import math
    import tempfile

    import torch

    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    t_phase = time.time()
    nproc = nproc or torch.cuda.device_count()
    dev_args = [] if device == "cuda" else ["--device", device]
    with tempfile.TemporaryDirectory() as tmp:
        train_root = synthetic_coco(os.path.join(tmp, "train"), NWPU_CLASSES, LOOP_TRAIN_SIZES,
                                    write_png, seed=2)
        val_root = synthetic_coco(os.path.join(tmp, "val"), NWPU_CLASSES, LOOP_VAL_SIZES,
                                  write_png, seed=3)
        work = os.path.join(tmp, "work")
        opts = _loop_options(train_root, val_root) + ["ckpt_interval=2", "val_interval=3",
                                                      "log_interval=1"]
        bsz = Config.fromfile(config)["train_dataloader"]["batch_size"]
        spe = len(LOOP_TRAIN_SIZES) // (bsz * nproc)
        out1 = _torchrun("rsprompter_tpu_torch.tools.train",
                         [config, "--work-dir", work, *dev_args, "--cfg-options", *opts,
                          "max_epochs=2"], nproc, f"tools.train, {nproc} rank(s), 2 epochs")
        out2 = _torchrun("rsprompter_tpu_torch.tools.train",
                         [config, "--work-dir", work, "--resume", *dev_args, "--cfg-options",
                          *opts, "max_epochs=3"], nproc, "tools.train --resume, epoch 3")
        recs = _read_records(work)
        train = [r for r in recs if "loss" in r]
        val = [r for r in recs if "coco/bbox_mAP" in r]
        iters = [r["iter"] for r in train]
        if (iters != list(range(1, 3 * spe + 1)) or len(val) != 1
                or not all(math.isfinite(r["loss"]) for r in train)
                or "resumed from" not in out2):
            raise AssertionError(f"torchrun tools.train: iters {iters}, {len(val)} validations, "
                                 f"losses {[r['loss'] for r in train]}")
        for step in (2 * spe, 3 * spe):
            if not os.path.isdir(os.path.join(work, "ckpts", f"step_{step}")):
                raise AssertionError(f"torchrun tools.train: no checkpoint at step {step}")
        log(f"torchrun tools.train: {nproc} rank(s) x batch {bsz}, {spe} steps an epoch, "
            f"losses {[round(r['loss'], 5) for r in train]}; resumed at step {2 * spe}; "
            f"validation over {nproc} rank(s): " + json.dumps({k: v for k, v in val[0].items()
                                                  if k.startswith(("coco/bbox_mAP",
                                                                   "val/"))}))

        eval_root, ckpt_path = write_eval_set(tmp, eval_config)
        out3 = _torchrun("rsprompter_tpu_torch.tools.test", [
            eval_config, ckpt_path, *dev_args, "--cfg-options", *_eval_options(eval_root)],
            nproc, "tools.test")
    got = {}
    n_images = None
    for line in out3.splitlines():
        key, sep, value = line.partition(": ")
        if sep and key.startswith("coco/"):
            got[key] = float(value)
        elif " images in " in line:
            n_images = int(line.split()[0])
    differ = {k: (got.get(k), v) for k, v in eval_metrics.items()
              if not (k in got and metric_close(got[k], v))}
    if differ or n_images != len(EVAL_SIZES):
        raise AssertionError(f"torchrun tools.test: {n_images} images; against phase 9: "
                             f"{differ}")
    log(f"torchrun tools.test, {nproc} rank(s): {n_images} images, each once; every metric "
        f"within {DP_METRIC_TOL} of phase 9's: {json.dumps(got)}")
    log(f"phase 19(b): {time.time() - t_phase:.1f} s")


def tensor_mode_phase(kernels, config: str = CONFIG, device: str = "cuda") -> dict:
    """Phase 19(c). ``forward(batch, mode='tensor')`` of the anchor
    detector at ViT-B 1024^2, batch 2, on phase 3's images: every output
    finite, in JAX's order and shapes (per-level RPN scores and deltas,
    then the RoI head's class logits and deltas on the NMS'd proposals and
    SAM's mask logits and IoU on the first ``num_mask_slots``), A, B and C
    launched as phase 3 counts a forward. Returns the launches."""
    import torch

    from rsprompter_tpu_torch.apis.inference import init_detector

    inf = init_detector(config, device=device, batch_size=2, seed=0)
    det = inf.model
    batch, _ = inf.make_batch(synthetic_images(0))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    det(batch, mode="tensor")  # warm-up
    sync()
    for k in kernels:
        k.reset_counts()
    t0 = time.perf_counter()
    out = det(batch, mode="tensor")
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k.name: dict(k.variant_launches) for k in kernels}
    if device == "cuda":
        for name, want in expected_forward_launches(det, 1).items():
            if counts[name] != want:
                raise AssertionError(f"tensor mode: {name} launches {counts[name]}, "
                                     f"expected {want}")
    b, h = batch["images"].shape[:2]
    a = det.anchor_generator.num_base_priors
    strides = det.anchor_generator.strides
    n = dict(det.test_cfg.get("rpn", {})).get("max_per_img", 1000)
    c = det.roi_head.num_classes
    m = min(n, det.roi_head.num_mask_slots)
    s = 4 * (h // det.backbone.config.patch_size)
    want = ([(b, h // st, h // st, a) for st in strides]
            + [(b, h // st, h // st, 4 * a) for st in strides]
            + [(b, n, c + 1), (b, n, 4 * c), (b, m, s, s), (b, m)])
    flat = list(out[0]) + list(out[1]) + list(out[2:])
    shapes = [tuple(t.shape) for t in flat]
    if shapes != want:
        raise AssertionError(f"tensor mode: shapes {shapes}, expected {want}")
    bad = [i for i, t in enumerate(flat) if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"tensor mode: non-finite outputs {bad}")
    log(f"tensor mode: RSPrompter-anchor, ViT-B {h}^2, batch {b}: {len(flat)} raw outputs, "
        f"finite, JAX's shapes {shapes}; {ms:.2f} ms a forward; launches {counts}")
    del inf, det, out
    return counts


# ---------------------------------------------------------------------------
# phase 20: the fp32 forwards (3xTF32) against plain fp32
# ---------------------------------------------------------------------------

# max |kernel - plain| / max |plain| of the fp32 encoder over the neck and
# every hidden state (SAM-det's segmentor; the bf16 kernels read 0.02484
# there on an H100, under ENCODER_TOL)
F32_ENCODER_TOL = 1e-3
F32_PATH = "samdet_predict"  # where ViT-B's fp32 rows count their launches
F32_WIDE_PATHS = {"large": "vit_l_fp32_encoder", "huge": "vit_h_fp32_encoder"}

# the WHU data path (phase 21)
WHU_CONFIG = os.path.join(ROOT, "configs", "rsprompter", "rsprompter_anchor-whu.py")
WHU_SEED = 0  # utils.synthetic.synthetic_whu's tree: 6 train tiles (and one without a mask), 4 test
# sha256 of the JAX tool's JSON (tools/rsprompter/whu2coco.py, with OpenCV)
# on that tree, split by split; tests/test_torch_whu.py holds them to it
WHU_JSON_SHA256 = {
    "train": "e0bf7fdeabc345e15d1dfc7aedebaecc8982cee4b2396cc70cfe9cf20867eee7",
    "test": "93e1dcc45151a1eadee02ed7d94240ae288d4dfb302b1bd840332f9788aa240a",
}


def f32_variants(expect: dict) -> dict:
    """Expected launch counts with every variant's fp32 name ('window' ->
    'window/f32'): the fp32 variants alone."""
    return {k: {f"{v}/f32": n for v, n in want.items()} for k, want in expect.items()}


def flash_odd_k12_f32_rows(rnd, rows, bsz: int, grid: int, win: int) -> list:
    """K10, K11 and K12' at fp32, at ViT-B's shapes (1024^2, batch 2), as
    phase 2 measures them in bf16: kernel C on the 'flash' route (ViT-B's
    fp32 C rows in ``rows`` under K10's names: the same kernel at the same
    shapes), kernel C at three heads on the window shape, and K12' (B's fp32
    GEMM alone) at the global and window shapes. No shipped fp32 config
    runs these (their launches read 0)."""
    from rsprompter_tpu_torch.models.sam.configs import sam_config
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    v = sam_config("base").vision_config
    c, heads = v.hidden_size, v.num_attention_heads
    out = [dict(r, name=f"relpos_attention/flash-{r['variant']}",
                replaces=FLASH_REPLACES[r["variant"].split("/")[0]], path=None)
           for r in rows if r["kernel"] is fa.RELPOS_ATTENTION and r["path"] == F32_PATH]
    odd = attention_rows(rnd, bsz, grid, 3, 64, win, tag="/odd-heads", variants=("window",))
    out += [dict(r, variant="window/odd/f32", replaces=ODD_HEADS_REPLACES, path=None)
            for r in odd]
    wq, bq = rnd(3 * c, c, scale=0.02), rnd(3 * c, scale=0.02)
    for variant, n_img, s in (("global", bsz, grid * grid), ("window", bsz * 25, win * win)):
        out.append(k12_row(f"qkv_headmajor/{variant}/f32", rnd(n_img * s, c), wq, bq,
                           3 * heads, n_img, variant, None))
    return out


def f32_phase(kernels, dev):
    """Phase 20: the fp32 forwards at ViT-B's shapes (1024^2, batch 2; their
    launches count on SAM-det's predict) and at ViT-L's and ViT-H's widths
    against their plain fp32 versions, then the ViT-L and ViT-H fp32
    encoders through them. Returns (rows, {path: launch counts})."""
    import torch

    from rsprompter_tpu_torch.models.sam.configs import sam_config

    t_phase = time.time()
    g = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    rows = []
    bsz, grid, win = 2, 64, 14
    with torch.no_grad():
        for arch, tag, path in (("base", "", F32_PATH),) + tuple(
                (arch, f"@vit-{arch[0]}", path) for arch, path in F32_WIDE_PATHS.items()):
            v = sam_config(arch).vision_config
            c, heads = v.hidden_size, v.num_attention_heads
            arch_rows = [mlp_row(rnd, dev, bsz * grid * grid, c, tag)]
            arch_rows += qkv_rows(rnd, dev, bsz, grid, c, heads, win, tag)
            arch_rows += attention_rows(rnd, bsz, grid, heads, c // heads, win, tag)
            for r in arch_rows:
                r["path"] = path
            rows += arch_rows
            torch.cuda.empty_cache()
        rows += flash_odd_k12_f32_rows(rnd, rows, bsz, grid, win)
    log_rows(rows, tol=F32_TOL)
    paths = {path: wide_encoder_check(arch, kernels, dev, f32=True)
             for arch, path in F32_WIDE_PATHS.items()}
    log(f"phase 20: {time.time() - t_phase:.1f} s")
    return rows, paths


FORMATS_DIR = os.path.join(ROOT, "tests", "data")
WHU_EPOCHS = 2  # of 3 steps: 6 train tiles at the config's batch of 2
WHU_TIMEOUT_S = 600


def format_fixture_check() -> int:
    """Every fixture of ``tests/data/formats/digests.json`` (PNG and TIFF
    forms, and the JPEG fixtures), read by ``data/io.imread`` in colour and
    in grey: the sha256 and shape ``cv2.imread`` gave where the digests
    were written. Returns the number of decodes checked."""
    import hashlib

    import numpy as np

    from rsprompter_tpu_torch.data.io import IMREAD_COLOR, IMREAD_GRAYSCALE, imread

    with open(os.path.join(FORMATS_DIR, "formats", "digests.json")) as f:
        digests = json.load(f)
    n = 0
    for key, want in sorted(digests.items()):
        for mode, flag in (("color", IMREAD_COLOR), ("gray", IMREAD_GRAYSCALE)):
            img = imread(os.path.join(FORMATS_DIR, key), flag)
            got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
            if got != want[mode]["sha256"] or list(img.shape) != want[mode]["shape"]:
                raise AssertionError(f"{key} ({mode}): {img.shape} {got[:12]}, OpenCV gave "
                                     f"{want[mode]['shape']} {want[mode]['sha256'][:12]}")
            n += 1
    return n


def tiff_decode_ms(root: str) -> dict:
    """Host ms a tile of ``decode_tiff`` on the tree's train tiles, by kind
    and compression (the median of each kind's files, 3 reads each); LZW
    on one mask re-encoded here."""
    import glob

    from rsprompter_tpu_torch.data import tiff

    out = {}
    for kind, sub, gray in (("image", "image", False), ("mask", "label", True)):
        by_comp = {}
        for path in sorted(glob.glob(os.path.join(root, "imgs", "train", sub, "*.tif"))):
            with open(path, "rb") as f:
                data = f.read()
            comp = {tiff.NONE: "none", tiff.PACKBITS: "packbits"}[
                tiff._ifd(data, path)[1][tiff.COMPRESSION][0]]
            for _ in range(3):
                t0 = time.perf_counter()
                tiff.decode_tiff(data, path, gray)
                by_comp.setdefault(comp, []).append(1e3 * (time.perf_counter() - t0))
        for comp, ms in by_comp.items():
            out[f"{kind}/{comp}"] = statistics.median(ms)
        if kind == "mask":
            mask = tiff.decode_tiff(data, path, True)
            lzw = tiff.encode_tiff(mask, tiff.MIN_IS_BLACK, compression=tiff.LZW,
                                   rows_per_strip=128)
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                again = tiff.decode_tiff(lzw, "lzw mask", True)
                ms.append(1e3 * (time.perf_counter() - t0))
            if not (again == mask).all():
                raise AssertionError("the LZW mask does not decode to the mask")
            out["mask/lzw"] = statistics.median(ms)
    return out


def _fake_slurm(bin_dir: str) -> dict:
    """A one-node SLURM job's environment, with an ``scontrol`` on ``PATH``
    that names this host (the card's machine has no SLURM)."""
    import socket

    os.makedirs(bin_dir, exist_ok=True)
    scontrol = os.path.join(bin_dir, "scontrol")
    with open(scontrol, "w") as f:
        f.write('#!/bin/sh\n[ "$1 $2" = "show hostnames" ] || exit 1\necho 127.0.0.1\n')
    os.chmod(scontrol, 0o755)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, SLURM_JOB_NODELIST="node0", SLURM_NNODES="1", SLURM_NTASKS="1",
               SLURM_NODEID="0", SLURM_PROCID="0", MASTER_PORT=str(port),
               PATH=f"{bin_dir}:{os.environ['PATH']}", PYTHONPATH=ROOT, OMP_NUM_THREADS="4")
    for key in ("MASTER_ADDR", "NNODES", "NODE_RANK", "GPUS_PER_NODE", "TRAIN_MODULE"):
        env.pop(key, None)
    return env


def _run_tool(cmd, env, what: str) -> str:
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=WHU_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    log(f"{what}: {time.time() - t0:.1f} s")
    return proc.stdout


# the module slurm_train.sh's rank runs (TRAIN_MODULE): tools.train's main,
# then the launch counts of this fresh process to $WHU_COUNTS
WHU_TRAIN_MODULE = """import json, os, sys
from rsprompter_tpu_torch.ops import _cuda
from rsprompter_tpu_torch.tools import train
train.main(sys.argv[1:])
with open(os.environ["WHU_COUNTS"], "w") as f:
    json.dump({k.name: k.variant_launches for k in _cuda.all_kernels()}, f)
"""


def whu_phase(kernels) -> dict:
    """Phase 21, the WHU data path, as a user runs it on a machine without
    OpenCV: the image-format fixtures; a seeded WHU-style tree of 512 x 512
    TIFF tiles (``utils.synthetic.synthetic_whu``, uncompressed and PackBits)
    through ``tools.rsprompter.whu2coco`` (its JSON text's sha256 must be
    the JAX tool's, ``WHU_JSON_SHA256``); ``tools.misc.print_config`` on
    ``rsprompter_anchor-whu.py``; ``tools.train`` on that config at full
    width (ViT-B, 1024^2, encoder frozen as configured, seeded weights)
    through ``tools/slurm_train.sh`` in a faked one-node SLURM job, two
    epochs of three steps; then ``tools.test`` on its checkpoint: every test
    tile evaluated, ``coco/segm_mAP`` printed. The launch counts (the rank
    runs ``WHU_TRAIN_MODULE``, which writes its own; ``tools.test``'s main
    runs in this process, counted from 0) must be A, B and C a forward as
    phase 3 counts one, and no backward kernel. Returns
    {path: launch counts}."""
    import contextlib
    import hashlib
    import io
    import math
    import tempfile
    import types

    from rsprompter_tpu_torch.data import contours
    from rsprompter_tpu_torch.models.sam.configs import sam_config
    from rsprompter_tpu_torch.tools import test as tools_test
    from rsprompter_tpu_torch.tools.misc import print_config
    from rsprompter_tpu_torch.tools.rsprompter import whu2coco
    from rsprompter_tpu_torch.utils.synthetic import WHU_SPLITS, synthetic_whu

    t_phase = time.time()
    card = card_line()
    t0 = time.time()
    n_decodes = format_fixture_check()
    log(f"image formats: {n_decodes} fixture decodes (PNG, TIFF, JPEG; colour and grey) equal "
        f"to OpenCV's digests in {time.time() - t0:.2f} s")
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "whu")
        t0 = time.time()
        synthetic_whu(root, WHU_SPLITS, seed=WHU_SEED)
        log(f"WHU tree: {sum(WHU_SPLITS.values())} tiles of 512^2 (and one image without a mask) "
            f"written in {time.time() - t0:.2f} s")
        decode = tiff_decode_ms(root)
        log("TIFF decode, host ms a tile (" + card + "): "
            + ", ".join(f"{k} {v:.3f}" for k, v in decode.items()))
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        t0 = time.time()
        contours.load_library()  # its first-use build stays out of whu2coco's time
        log(f"contours library built and loaded in {time.time() - t0:.2f} s")
        for split, n in WHU_SPLITS.items():
            out = os.path.join(root, "annotations", f"WHU_building_{split}.json")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                whu2coco.main([os.path.join(root, "imgs", split, "image"),
                               os.path.join(root, "imgs", split, "label"), out])
            ms = 1e3 * (time.perf_counter() - t0) / (n + (split == "train"))
            with open(out, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != WHU_JSON_SHA256[split]:
                raise AssertionError(f"whu2coco {split}: sha256 {digest}, the JAX tool's "
                                     f"{WHU_JSON_SHA256[split]}")
            log(f"whu2coco {split}: {said.getvalue().strip()}; sha256 {digest[:16]} (the JAX "
                f"tool's); {ms:.1f} host ms a tile ({card})")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            print_config.main([WHU_CONFIG])
        printed = json.loads(said.getvalue())
        if printed["model"]["num_classes"] != 1:
            raise AssertionError(f"print_config: num_classes {printed['model']['num_classes']}")
        log(f"print_config {os.path.basename(WHU_CONFIG)}: {len(said.getvalue())} bytes of JSON, "
            f"model.num_classes 1, train_dataloader.dataset.type "
            f"{printed['train_dataloader']['dataset']['type']}")

        opts = [f"{s}_dataloader.dataset.data_root={root}" for s in ("train", "val", "test")]
        opts += [f"max_epochs={WHU_EPOCHS}", "val_interval=100", f"ckpt_interval={WHU_EPOCHS}",
                 "log_interval=1"]
        env = _fake_slurm(os.path.join(tmp, "bin"))
        with open(os.path.join(tmp, "whu_train_counts.py"), "w") as f:
            f.write(WHU_TRAIN_MODULE)
        env.update(TRAIN_MODULE="whu_train_counts", PYTHONPATH=f"{tmp}:{ROOT}",
                   WHU_COUNTS=os.path.join(tmp, "train_counts.json"))
        work = os.path.join(tmp, "work")
        _run_tool(["bash", os.path.join(ROOT, "rsprompter_tpu_torch", "tools", "slurm_train.sh"),
                   WHU_CONFIG, "--work-dir", work, "--cfg-options", *opts], env,
                  "slurm_train.sh -> tools.train (one node, faked SLURM)")
        recs = _read_records(work)
        train = [r for r in recs if "loss" in r]
        steps = WHU_EPOCHS * (WHU_SPLITS["train"] // 2)
        if [r["iter"] for r in train] != list(range(1, steps + 1)) or not all(
                math.isfinite(r["loss"]) for r in train):
            raise AssertionError(f"WHU tools.train: {[(r['iter'], r['loss']) for r in train]}")
        ckpt = os.path.join(work, "ckpts", f"step_{steps}")
        if not os.path.isdir(ckpt):
            raise AssertionError(f"WHU tools.train: no checkpoint at step {steps}")
        s_iter = [1.0 / r["it_per_s"] for r in train]
        log(f"WHU tools.train: {steps} steps at batch 2, losses "
            f"{[round(r['loss'], 4) for r in train]}; s an iteration {s_iter[0]:.3f} (the first) "
            f"then median {statistics.median(s_iter[1:]):.3f} ({card})")
        with open(env["WHU_COUNTS"]) as f:
            counts = {"train": json.load(f)}
        # tools.test in this process (its main, as a user's `python -m` runs
        # it), its launches counted from 0
        for k in kernels:
            k.reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            report = tools_test.main([WHU_CONFIG, ckpt, "--cfg-options", *opts])
        counts["test"] = {k.name: dict(k.variant_launches) for k in kernels}
        printed = dict(line.partition(": ")[::2] for line in said.getvalue().splitlines())
        n_images = report["timing"]["images"]
        if n_images != WHU_SPLITS["test"] or "coco/segm_mAP" not in printed:
            raise AssertionError(f"WHU tools.test: {n_images} images, coco/segm_mAP printed: "
                                 f"{'coco/segm_mAP' in printed}")
        log(f"WHU tools.test on the checkpoint: {time.time() - t0:.1f} s; {n_images} images, "
            f"coco/segm_mAP {printed['coco/segm_mAP']} (random weights: not gated), "
            f"{n_images / report['timing']['wall_s']:.3f} images/s ({card})")
        enc = types.SimpleNamespace(config=sam_config("base").vision_config)
        for name, forwards in (("train", steps), ("test", -(-WHU_SPLITS["test"] // 2))):
            check_launches(f"WHU tools.{name}", counts[name],
                           frozen_forward_launches(enc, forwards))
            paths[f"whu_{name}"] = counts[name]
            log(f"WHU tools.{name}: A, B and C launched for each of {forwards} forwards "
                f"(12 layers, 4 global), no backward kernel: "
                + json.dumps({k: v for k, v in counts[name].items() if v}))
    log(f"phase 21: {time.time() - t_phase:.1f} s")
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="timed forwards of the main path")
    parser.add_argument("--train-steps", type=int, default=10,
                        help="timed steps of each train step (after one warm-up)")
    parser.add_argument("--profile-dir", default="",
                        help="also write torch.profiler tables of one forward, one "
                             "train step, one query forward per route and one query "
                             "train step here")
    args = parser.parse_args()
    t_start = time.time()

    sys.path.insert(0, ROOT)
    enable_bytecode_cache()
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
    evaluation = eval_phase(kernels)
    paths["query_train_step"] = query_train_phase(kernels, args.train_steps, args.profile_dir)
    paths["train_loop"] = train_loop_phase(kernels, args.profile_dir)
    rows += lora_kernel_rows(dev)
    paths["peft_train_step"] = peft_phase(kernels, args.train_steps, args.profile_dir)
    for name, c in sam_baselines_phase(kernels, args.iters, args.profile_dir).items():
        paths[f"{name}_predict"] = c
    baseline_paths, baseline_rows = baselines_train_phase(kernels, args.train_steps,
                                                          args.profile_dir, dev=dev)
    paths.update(baseline_paths)
    rows += baseline_rows
    rows += wide_kernel_rows(dev)
    paths.update(widths_phase(kernels, args.iters, dev, args.profile_dir))
    rows += wide_backward_rows(dev)
    paths.update(wide_train_phase(kernels, WIDE_TRAIN_STEPS, dev))
    paths["serve"] = serving_phase(kernels)
    paths[TTA_PATH], tta_rows = tta_tools_phase(kernels)
    rows += tta_rows
    rows += backward_kernel_phase(dev, bsz=DP_BATCH, kinds=("A'", "B'", "C'"), path=DP_PATH)
    paths[DP_PATH] = dp_phase(kernels, evaluation)
    ddp_overhead()
    torchrun_phase(evaluation["metrics"])
    paths[TENSOR_PATH] = tensor_mode_phase(kernels)
    f32_kernel_rows, f32_paths = f32_phase(kernels, dev)
    rows += f32_kernel_rows
    paths.update(f32_paths)
    paths.update(whu_phase(kernels))
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
