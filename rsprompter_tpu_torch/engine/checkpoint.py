"""Pretrained SAM weights -> the port's detector.

Counterpart of ``rsprompter_tpu/engine/checkpoint.py`` (``SAM_SUBTREE_PREFIXES``
:83, ``load_sam_pretrained`` :199) and of the load-time helpers of
``rsprompter_tpu/utils/torch_convert.py`` (``_resize_abs_pos_embed`` :71,
``_resize_rel_pos`` :88, the resize rule of ``_transform`` :139,
``load_torch_checkpoint`` :262), copied here: the port imports nothing of the
JAX package.

A Hugging Face SAM checkpoint (``pytorch_model.bin``, ``model.safetensors``)
names its tensors ``vision_encoder.*``, ``shared_image_embedding.*``,
``mask_decoder.*`` and ``prompt_encoder.*``, in torch layouts. The port's
modules already carry the same names and layouts below their own prefixes
(``backbone.*``, ``roi_head.mask_head.mask_decoder.*``, ...), so loading is a
prefix rename per subtree, a copy cast to the parameter's dtype, and two
resizes for a checkpoint made at another input size: the absolute position
embedding (bicubic) and the global layers' rel-pos tables (linear). Any other
shape mismatch raises. Parameters the file does not hold keep their values
and are reported, as JAX reports them.

``init_detector`` and ``build_trainer`` call :func:`load_config_sam` after
the seeded init and before the bf16 cast: when the config's
``hf_sam_pretrain_ckpt_path`` (or ``sam_checkpoint``) names a file that
exists, its SAM tensors replace the random ones; when it does not, nothing
changes, as in JAX.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

# the port's module prefix -> the HF SAM key prefix, per detector family
# (JAX's SAM_SUBTREE_PREFIXES with its flax paths as the port's module
# paths; a prefix the model does not have is skipped, as JAX skips it)
SAM_SUBTREE_PREFIXES: Dict[str, Dict[str, str]] = {
    "RSPrompterAnchor": {
        "backbone.": "vision_encoder.",
        "shared_image_embedding.": "shared_image_embedding.",
        "roi_head.mask_head.mask_decoder.": "mask_decoder.",
        "roi_head.mask_head.no_mask_embed.": "prompt_encoder.no_mask_embed.",
    },
    "RSPrompterQuery": {
        "backbone.": "vision_encoder.",
        "shared_image_embedding.": "shared_image_embedding.",
        "panoptic_head.mask_decoder.": "mask_decoder.",
        "panoptic_head.no_mask_embed.": "prompt_encoder.no_mask_embed.",
        "panoptic_head.mask_embed_prompt.": "prompt_encoder.mask_embed.",
    },
}
TIED_KEY = "prompt_encoder.shared_embedding.positional_embedding"
TIED_SOURCE = "shared_image_embedding.positional_embedding"


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.bin`` / ``.pth`` (torch pickle, a ``state_dict`` entry unwrapped)
    or ``.safetensors`` file -> {name: CPU tensor}."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(str(path), device="cpu"))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def tie_shared_embedding(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """HF ties ``prompt_encoder.shared_embedding`` to ``shared_image_embedding``
    and may save only the latter: add the former where it is missing."""
    sd = dict(state_dict)
    if TIED_KEY not in sd and TIED_SOURCE in sd:
        sd[TIED_KEY] = sd[TIED_SOURCE]
    return sd


def resize_abs_pos_embed(t: torch.Tensor, hw) -> torch.Tensor:
    """(1, H, W, C) -> (1, h, w, C), bicubic, align_corners=False, fp32 (the
    reference's ``resize_pos_embed``)."""
    x = t.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(hw), mode="bicubic", align_corners=False)
    return x.permute(0, 2, 3, 1)


def resize_rel_pos(t: torch.Tensor, length: int) -> torch.Tensor:
    """(L1, C) -> (L2, C), linear, align_corners=False, fp32 (the
    reference's ``_prepare_relative_position``)."""
    x = F.interpolate(t.float().t().unsqueeze(0), size=int(length), mode="linear")
    return x.squeeze(0).t()


def _fit(name: str, src: torch.Tensor, shape) -> torch.Tensor:
    """The checkpoint's tensor in the parameter's shape, resized where JAX's
    ``_transform`` resizes; any other mismatch raises."""
    src = src.detach().cpu().float()
    shape = tuple(shape)
    if tuple(src.shape) != shape:
        leaf = name.rsplit(".", 1)[-1]
        if (leaf == "pos_embed" and src.ndim == 4 and len(shape) == 4
                and src.shape[0] == shape[0] == 1 and src.shape[3] == shape[3]):
            src = resize_abs_pos_embed(src, shape[1:3])
        elif (leaf in ("rel_pos_h", "rel_pos_w") and src.ndim == 2 and len(shape) == 2
              and src.shape[1] == shape[1]):
            src = resize_rel_pos(src, shape[0])
    if tuple(src.shape) != shape:
        raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(src.shape)} "
                         f"vs model {shape}")
    return src


def load_sam_pretrained(model: nn.Module, state_dict: Mapping[str, Any], model_type: str,
                        verbose: bool = True) -> Dict[str, Dict[str, int]]:
    """Fill ``model``'s SAM-derived parameters in place from a HF SAM
    state_dict. Returns {module prefix: {'used': n, 'missing': n}} for each
    prefix the model has."""
    if model_type not in SAM_SUBTREE_PREFIXES:
        raise NotImplementedError(f"no SAM checkpoint map for '{model_type}' in the port")
    sd = tie_shared_embedding(state_dict)
    own = model.state_dict(keep_vars=True)
    report = {}
    for prefix, hf_prefix in SAM_SUBTREE_PREFIXES[model_type].items():
        names = [n for n in own if n.startswith(prefix)]
        if not names:
            continue
        missing = []
        with torch.no_grad():
            for name in names:
                key = hf_prefix + name[len(prefix):]
                if key not in sd:
                    missing.append(key)
                    continue
                dst = own[name]
                dst.copy_(_fit(name, torch.as_tensor(sd[key]), dst.shape).to(dst.dtype))
        report[prefix.rstrip(".")] = dict(used=len(names) - len(missing), missing=len(missing))
        if verbose and missing:
            print(f"[load_sam_pretrained] {prefix.rstrip('.')}: {len(missing)} missing "
                  f"(first: {missing[:3]})")
    return report


def load_config_sam(model: nn.Module, model_cfg: Mapping[str, Any]):
    """Load the config's SAM checkpoint into ``model`` when the file exists
    (the report), else leave the model as it is (None; with a warning where
    the config names a file that is absent), as JAX's ``apis/inferencer.py``
    and ``tools/train.py`` do."""
    path = model_cfg.get("hf_sam_pretrain_ckpt_path") or model_cfg.get("sam_checkpoint")
    if not path:
        return None
    if not os.path.exists(path):
        warnings.warn(f"SAM checkpoint {path} not found; the SAM weights stay random",
                      stacklevel=3)
        return None
    report = load_sam_pretrained(model, load_torch_checkpoint(path), model_cfg["type"])
    print(f"loaded SAM pretrain from {path}: {report}")
    return report
