"""Parameters and floating-point operations of a detector's predict or loss.

    python -m rsprompter_tpu_torch.tools.analysis_tools.get_flops CONFIG \\
        [--batch 1] [--mode predict|loss] [--device cuda|cpu] [--cfg-options ...]

The port's counterpart of the JAX package's
``tools/analysis_tools/get_flops.py`` (the reference's). JAX reads XLA's
cost analysis of the compiled function, which counts every operation,
element-wise ones too. The port counts with
``torch.utils.flop_counter.FlopCounterMode``, which counts products and
convolutions (2 a multiply-add): matrix products, batched products and
einsums, convolutions and attention. The count runs in fp32 over
``utils.testing.demo_batch`` at the config's ``crop_size``, on the card
unless ``--device cpu`` is given. The hand-written kernels run through
ctypes and are opaque to the counter, so the encoder takes its kernels'
plain versions (``impl = 'plain'``), which do the same work: the count is
the same on either device, and no kernel may launch while it runs.
Parameters count every parameter and floating buffer (BN statistics), as
JAX counts its variables.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from rsprompter_tpu_torch.apis.build import build_detector, init_random_weights
from rsprompter_tpu_torch.apis.inference import resolve_device
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.ops._cuda import all_kernels
from rsprompter_tpu_torch.utils.testing import demo_batch

NOTE = ("products and convolutions only (torch.utils.flop_counter); XLA's count in the "
        "JAX tool also has element-wise work")


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)``'s products and convolutions; raises
    if a hand-written kernel launched, as the counter cannot see its work."""
    kernels = all_kernels()
    before = [dict(k.variant_launches) for k in kernels]
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    launched = [k.name for k, b in zip(kernels, before) if k.variant_launches != b]
    if launched:
        raise RuntimeError(f"get_flops: kernels {launched} launched; the count misses their work")
    return counter.get_total_flops()


def count_params(model: torch.nn.Module) -> int:
    return (sum(p.numel() for p in model.parameters())
            + sum(b.numel() for b in model.buffers() if b.is_floating_point()))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description="parameters and FLOPs of a detector")
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--mode", default="predict", choices=["predict", "loss"])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cfg-options", nargs="+", default=None)
    args = p.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    crop = tuple(cfg.get("crop_size", (1024, 1024)))
    device = resolve_device(args.device)
    model = build_detector(cfg["model"])
    init_random_weights(model, 0)
    model.to(device)
    for m in model.modules():
        if isinstance(m, SamVisionEncoder):
            m.impl = "plain"
    # no parameter takes a gradient: the counter's module tracker cannot
    # hook the views of parameters that a no-grad forward makes
    model.requires_grad_(False)
    batch = demo_batch(args.batch, crop, max_gt=8, device=device)
    with torch.no_grad():
        if args.mode == "loss":
            model.train()
            gen = torch.Generator(device=device).manual_seed(1)
            flops = count_flops(model.loss, batch, generator=gen)
        else:
            model.eval()
            flops = count_flops(model.predict, {k: batch[k] for k in ("images", "img_shape")})
    n_params = count_params(model)
    print(f"mode: {args.mode}  input: {args.batch}x{crop}  device: {device}")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops: {flops / 1e9:.2f} GFLOPs ({NOTE})")
    return dict(params=n_params, flops=flops, mode=args.mode, input=(args.batch, *crop))


if __name__ == "__main__":
    main()
