"""Model builder: reference-flavoured config dict -> torch detector.

Counterpart of ``rsprompter_tpu/apis/build.py`` (:102-135) for every
family, predict and the train step each: ``type='RSPrompterAnchor'``,
``'RSPrompterQuery'`` (with ``decoder_plus=False`` too, which JAX's builder
drops), ``'SAMDet'``, ``'SAMSegMaskRCNN'`` and ``'SAMSegMask2Former'``.
Keeps the key vocabulary
(``hf_sam_pretrain_name``, ``prompt_shape``, ``num_classes``, ``train_cfg``,
``test_cfg``, ``bf16``, ``attn_impl``, ``train_backbone``,
``decoder_freeze``, ``decoder_plus``, ``num_samples``, ``pos_fraction``,
``peft_config``,
``aggregator_type``, ``mask_loss_resolution``, ``resnet_depth``, the
tiny-model ``vision_config`` override -- SAM-det's segmentor takes it too,
where JAX ignores it -- and the ``rpn_strides`` / ``roi_strides`` ladders),
and derives the optimizer's freeze and override paths
(``freeze_paths_for``).

``attn_impl`` picks the encoder's route (``models/sam/vision_encoder.py``):
``'fused'`` (the default, kernels A, B, C) or ``'flash'`` (K12' and C). Any
other value raises; the plain versions serve the tests and checks only.
``peft_config`` (the peft configs: ``r`` 16, ``lora_alpha`` 32) gives every
encoder block JAX's qkv adapter, which takes the LoRA route on either
``attn_impl`` (K12' with the adapter, never kernel B).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from rsprompter_tpu_torch.models.detectors.rsprompter_anchor import RSPrompterAnchor
from rsprompter_tpu_torch.models.detectors.rsprompter_query import (
    RSPrompterQuery,
    SAMSegMask2Former,
)
from rsprompter_tpu_torch.models.detectors.samdet import SAMDet
from rsprompter_tpu_torch.models.detectors.two_stage import SAMSegMaskRCNN
from rsprompter_tpu_torch.models.sam.common import (
    Conv2d,
    FastConvTranspose2x2,
    Fp32Linear,
    GroupNorm,
    Linear,
    SamLayerNorm,
)
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.positional import SamPositionalEmbedding

FAMILIES = ("RSPrompterAnchor", "RSPrompterQuery", "SAMDet", "SAMSegMaskRCNN",
            "SAMSegMask2Former")
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


def build_detector(model_cfg: Dict[str, Any]) -> nn.Module:
    """Build the detector module (fp32 parameters) from a config dict."""
    cfg = dict(model_cfg)
    mtype = cfg.pop("type")
    if mtype not in FAMILIES:
        raise NotImplementedError(f"detector type '{mtype}' is not ported to torch yet")
    arch = _arch_from_cfg(cfg)
    peft = cfg.get("peft_config") or {}
    common = dict(
        arch=arch,
        image_size=cfg.get("image_size", 1024),
        num_classes=cfg.get("num_classes", 1),
        test_cfg=cfg.get("test_cfg"),
        attn_impl=cfg.get("attn_impl", "fused"),
        train_cfg=cfg.get("train_cfg"),
    )
    if cfg.get("vision_config") is not None:
        common["vision_config"] = SamVisionConfig(**cfg["vision_config"])
    if mtype in ("RSPrompterAnchor", "SAMSegMaskRCNN", "SAMDet"):
        for key in ("rpn_strides", "roi_strides"):
            if cfg.get(key) is not None:
                common[key] = tuple(cfg[key])
    samples = dict(num_samples=cfg.get("num_samples", 512),
                   pos_fraction=cfg.get("pos_fraction", 0.25))
    if mtype == "SAMDet":
        return SAMDet(**common, **samples, resnet_depth=cfg.get("resnet_depth", 50))
    common.update(
        select_layers=tuple(cfg.get("select_layers", _ARCH_SELECT_LAYERS[arch])),
        aggregator_type=cfg.get("aggregator_type", "multi"),
        aggregator_hidden=cfg.get("aggregator_hidden", 32),
        lora_rank=peft.get("r", 0),
        lora_alpha=peft.get("lora_alpha", 32.0),
        # with LoRA the encoder runs under autograd: the optimizer's groups
        # freeze all of it but the adapters (JAX :96, :110)
        freeze_backbone=cfg.get("peft_config") is None and not cfg.get("train_backbone", False),
    )
    if mtype == "SAMSegMaskRCNN":
        return SAMSegMaskRCNN(**common, **samples)
    common.update(prompt_shape=tuple(cfg.get("prompt_shape", (100, 5))),
                  with_sincos=cfg.get("with_sincos", True))
    if mtype == "SAMSegMask2Former":
        return SAMSegMask2Former(**common)
    if mtype == "RSPrompterQuery":
        return RSPrompterQuery(**common, decoder_plus=cfg.get("decoder_plus", True))
    return RSPrompterAnchor(
        **common,
        multimask_output=cfg.get("multimask_output", False),
        num_samples=cfg.get("num_samples", 256),
        pos_fraction=cfg.get("pos_fraction", 0.25),
        mask_loss_resolution=cfg.get("mask_loss_resolution", "full"),
    )


def freeze_paths_for(model_cfg: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """(freeze, override): parameter-name substrings the optimizer leaves
    untouched, and those that train even where a freeze path matches, per
    the reference's freeze rules (JAX :155-177): the encoder unless
    ``train_backbone``, its LoRA adapters (``lora_a``, ``lora_b``) training
    under ``peft_config``; with ``decoder_freeze`` the shared PE, the SAM
    mask decoder and ``no_mask_embed``. SAM-det freezes its ``segmentor``
    (the whole SAM) and nothing else: its ``backbone`` is the detector's
    ResNet, which trains."""
    freeze: List[str] = []
    override: List[str] = []
    if not model_cfg.get("train_backbone", False):
        freeze.append("backbone")
        if model_cfg.get("peft_config") is not None:
            override += ["lora_a", "lora_b"]
    if model_cfg["type"] in ("RSPrompterAnchor", "RSPrompterQuery") and model_cfg.get(
            "decoder_freeze", True):
        freeze += ["shared_image_embedding", "mask_decoder", "no_mask_embed"]
    if model_cfg["type"] == "SAMDet":
        freeze = ["segmentor"]
    return freeze, override


# modules whose parameters keep fp32 when the model computes in bf16 (the
# JAX package gives them no compute dtype either)
_FP32_MODULES = (SamLayerNorm, GroupNorm, nn.BatchNorm2d, nn.Embedding,
                 SamPositionalEmbedding, Fp32Linear)


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
        if (isinstance(mod, (Linear, Conv2d, FastConvTranspose2x2))
                and not isinstance(mod, _FP32_MODULES)):
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
