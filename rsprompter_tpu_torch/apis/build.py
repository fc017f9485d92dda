"""Model builder: reference-flavoured config dict -> torch detector.

Counterpart of ``rsprompter_tpu/apis/build.py`` for the one family this port
covers so far (``type='RSPrompterAnchor'``, predict and the train step).
Keeps the key vocabulary (``hf_sam_pretrain_name``, ``prompt_shape``,
``num_classes``, ``train_cfg``, ``test_cfg``, ``bf16``, ``train_backbone``,
``decoder_freeze``, ``num_samples``, ``pos_fraction``, the tiny-model
``vision_config`` override and the ``rpn_strides`` / ``roi_strides``
ladders), and derives the optimizer's freeze paths (``freeze_paths_for``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.detectors.rsprompter_anchor import RSPrompterAnchor
from rsprompter_tpu_torch.models.sam.common import (
    Conv2d,
    FastConvTranspose2x2,
    Linear,
    SamLayerNorm,
)
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.positional import SamPositionalEmbedding

_ARCH_SELECT_LAYERS = {
    "base": tuple(range(1, 13, 2)),
    "large": tuple(range(1, 25, 2)),
    "huge": tuple(range(1, 33, 2)),
}


def _arch_from_cfg(cfg: Dict[str, Any]) -> str:
    name = cfg.get("hf_sam_pretrain_name") or cfg.get("arch", "base")
    for key in ("base", "large", "huge"):
        if key in name:
            return key
    return name


def build_detector(model_cfg: Dict[str, Any]) -> RSPrompterAnchor:
    """Build the detector module (fp32 parameters) from a config dict."""
    cfg = dict(model_cfg)
    mtype = cfg.pop("type")
    if mtype != "RSPrompterAnchor":
        raise NotImplementedError(f"detector type '{mtype}' is not ported to torch yet")
    if cfg.get("peft_config") is not None:
        raise NotImplementedError("LoRA (peft_config) is not ported to torch yet")
    if cfg.get("mask_loss_resolution", "full") != "full":
        raise NotImplementedError("mask_loss_resolution='low' is not ported to torch yet")
    arch = _arch_from_cfg(cfg)
    kw = {}
    if cfg.get("vision_config") is not None:
        kw["vision_config"] = SamVisionConfig(**cfg["vision_config"])
    for key in ("rpn_strides", "roi_strides"):
        if cfg.get(key) is not None:
            kw[key] = tuple(cfg[key])
    return RSPrompterAnchor(
        arch=arch,
        image_size=cfg.get("image_size", 1024),
        num_classes=cfg.get("num_classes", 1),
        prompt_shape=tuple(cfg.get("prompt_shape", (100, 5))),
        select_layers=tuple(cfg.get("select_layers", _ARCH_SELECT_LAYERS[arch])),
        aggregator_hidden=cfg.get("aggregator_hidden", 32),
        with_sincos=cfg.get("with_sincos", True),
        multimask_output=cfg.get("multimask_output", False),
        num_samples=cfg.get("num_samples", 256),
        pos_fraction=cfg.get("pos_fraction", 0.25),
        freeze_backbone=not cfg.get("train_backbone", False),
        train_cfg=cfg.get("train_cfg"),
        test_cfg=cfg.get("test_cfg"),
        **kw,
    )


def freeze_paths_for(model_cfg: Dict[str, Any]) -> List[str]:
    """Parameter-name substrings the optimizer leaves untouched, per the
    reference's freeze rules (the encoder unless ``train_backbone``; with
    ``decoder_freeze`` the shared PE, the SAM mask decoder and
    ``no_mask_embed``). JAX's LoRA train overrides wait for LoRA."""
    freeze: List[str] = []
    if not model_cfg.get("train_backbone", False):
        freeze.append("backbone")
    if model_cfg["type"] == "RSPrompterAnchor" and model_cfg.get("decoder_freeze", True):
        freeze += ["shared_image_embedding", "mask_decoder", "no_mask_embed"]
    return freeze


# modules whose parameters keep fp32 when the model computes in bf16 (the
# JAX package gives them no compute dtype either)
_FP32_MODULES = (SamLayerNorm, nn.BatchNorm2d, nn.Embedding, SamPositionalEmbedding)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype,
                      cast_params: bool = True) -> nn.Module:
    """Make every linear and convolution compute in ``dtype``, as JAX's
    ``dtype=`` does. ``cast_params=False`` keeps fp32 master parameters, cast
    at each use (training: autograd carries the gradient back through the
    cast to the fp32 parameter); ``cast_params=True`` also casts the weights
    of those layers, the rel-pos tables and the pos-embed in place, which
    saves the per-use casts (predict). Norms, embeddings and the Fourier
    projection stay fp32 either way."""
    for mod in model.modules():
        if isinstance(mod, (Linear, Conv2d, FastConvTranspose2x2)):
            mod.compute_dtype = dtype
        if cast_params and not isinstance(mod, _FP32_MODULES):
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> None:
    """Seeded random weights: torch's default initialisers, plus non-zero
    pos-embed (N(0, 0.02)) and rel-pos tables (zero at init, non-zero in
    every trained SAM). The tables take N(0, 0.5), as in the CPU parity
    tests, so the rel-pos bias moves the softmax at least as much as q.k
    does and a check of the encoder's output sees it."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for mod in model.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters()
        for name, p in model.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
            elif name.endswith("pos_embed"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif name.endswith("positional_embedding"):
                p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[1]))
