"""Pretrained SAM weights -> the port's detector; the runner's train
checkpoints.

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
and are reported, as JAX reports them: the peft configs' LoRA adapters
(``qkv_lora_a`` / ``qkv_lora_b``, which SAM has not) count as missing and
stay at their init. A train checkpoint holds them, with their AdamW
moments, as it holds every parameter.

``init_detector`` and ``build_trainer`` call :func:`load_config_sam` after
the seeded init and before the bf16 cast: when the config's
``hf_sam_pretrain_ckpt_path`` (or ``sam_checkpoint``) names a file that
exists, its SAM tensors replace the random ones; when it does not, nothing
changes, as in JAX.

A reference-trained mmengine ``.pth`` (the paper's weights) loads through
:func:`load_reference_checkpoint`, the counterpart of JAX's
(``engine/checkpoint.py`` ``REFERENCE_PTH_REVISE_KEYS`` :126,
``_split_packed_mha`` :147, ``load_reference_checkpoint`` :170): the
reference wraps its HF modules one level deep and packs mmdet's
``MultiheadAttention`` qkv as ``attn.in_proj_*``; the port's modules take
the reference's names otherwise (the query head's mmdet names included), so
the map is the prefix revisions and the split. A reference-trained SAM-det
file (``detector.*``) has no map, in JAX either: it raises, and the port's
own state_dict of SAM-det loads as for any family. JAX's reordering of the
linears fed by a flattened conv map (``REFERENCE_FLATTEN_LINEARS`` :141,
NCHW -> NHWC) is the identity here: the port flattens NCHW, as the
reference does.

The runner's checkpoints (``save_checkpoint`` :18, ``latest_checkpoint``
:29, ``restore_train_params`` :42, ``restore_checkpoint`` :56, ``_prune``
:67) keep JAX's layout, ``ckpts/step_{n}/`` with the newest ``keep`` kept;
each holds one ``torch.save`` of the trainer's state. JAX's orbax
directories are not read.
"""

from __future__ import annotations

import os
import re
import shutil
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rsprompter_tpu_torch.parallel.distributed import barrier, is_main

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
    "SAMSegMaskRCNN": {"backbone.": "vision_encoder."},
    "SAMSegMask2Former": {"backbone.": "vision_encoder."},
    "SAMDet": {"segmentor.": ""},  # the whole SAM, HF names one to one
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


# reference-trained mmengine .pth -> the port's names (JAX's revisions but
# those that turn mmdet's names into flax's: the port keeps mmdet's)
REFERENCE_PTH_REVISE_KEYS = (
    (r"^module\.", ""),
    (r"^backbone\.vision_encoder\.", "backbone."),
    (r"^shared_image_embedding\.shared_image_embedding\.", "shared_image_embedding."),
    (r"^neck\.feature_aggregator\.", "neck_feature_aggregator."),
    (r"^neck\.feature_spliter\.", "neck_feature_spliter."),
    (r"\.mask_decoder\.mask_decoder\.", ".mask_decoder."),
)


# reference-trained files that no rule maps: SAM-det's Faster R-CNN half
# (``detector.*``), for which JAX's map has no rule either
UNMAPPED_REFERENCE_PREFIXES = ("detector.",)


def is_reference_state_dict(state_dict: Mapping[str, Any]) -> bool:
    """True for a reference-trained mmengine file: one whose names the
    reference map renames (no name of the port's is renamed) or that holds
    names no rule maps."""
    renamed = split_packed_mha(revise_keys(state_dict))
    return any(k not in renamed or k.startswith(UNMAPPED_REFERENCE_PREFIXES)
               for k in state_dict)


def revise_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in state_dict.items():
        for pattern, repl in REFERENCE_PTH_REVISE_KEYS:
            k = re.sub(pattern, repl, k)
        out[k] = v
    return out


def split_packed_mha(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torch ``nn.MultiheadAttention``'s packed qkv (``attn.in_proj_*``) ->
    separate ``q_proj`` / ``k_proj`` / ``v_proj``; ``attn.out_proj`` ->
    ``out_proj``."""
    out = {}
    for k, v in state_dict.items():
        m = re.match(r"^(.*)\.attn\.in_proj_(weight|bias)$", k)
        if m:
            c = v.shape[0] // 3
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{m.group(1)}.{name}.{m.group(2)}"] = v[i * c:(i + 1) * c]
        else:
            out[k.replace(".attn.out_proj.", ".out_proj.")] = v
    return out


def load_reference_checkpoint(model: nn.Module, state_dict: Mapping[str, Any],
                              strict: bool = True, verbose: bool = True
                              ) -> Tuple[List[str], List[str]]:
    """Load a reference-trained mmengine state_dict into ``model`` in place,
    each tensor cast to its parameter's dtype (and resized where the SAM
    loader resizes). Returns (missing, unused): the model's names the file
    does not fill, the file's names the model does not have; with
    ``strict`` either raises, as ``load_state_dict(strict=True)`` does."""
    unmapped = [k for k in state_dict if k.startswith(UNMAPPED_REFERENCE_PREFIXES)]
    if unmapped:
        raise NotImplementedError(
            f"reference checkpoint: no map for {unmapped[:3]} (a reference-trained SAM-det "
            "file; neither package maps its detector.* names); load the port's own "
            "state_dict instead")
    sd = split_packed_mha(revise_keys(state_dict))
    own = model.state_dict(keep_vars=True)
    missing = [k for k in own if k not in sd]
    unused = [k for k in sd if k not in own]
    if strict and (missing or unused):
        raise KeyError(f"reference checkpoint: {len(missing)} missing (first: {missing[:5]}), "
                       f"{len(unused)} unused (first: {unused[:5]})")
    with torch.no_grad():
        for name, dst in own.items():
            if name in sd:
                dst.copy_(_fit(name, torch.as_tensor(sd[name]), dst.shape).to(dst.dtype))
    if verbose:
        print(f"[load_reference_checkpoint] loaded {len(own) - len(missing)} tensors, "
              f"{len(missing)} missing, {len(unused)} unused")
    return missing, unused


# ---------------------------------------------------------------------------
# The runner's train checkpoints (JAX :18-77, orbax there, torch.save here)
# ---------------------------------------------------------------------------

CKPT_FILE = "state.pt"


def _step_dirs(ckpt_dir: str) -> List[Tuple[int, str]]:
    return sorted(
        (int(d.split("_")[1]), d)
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    )


def save_checkpoint(ckpt_dir: str, trainer, step: int, keep: int = 5) -> str:
    """Write ``trainer.state_dict()`` (fp32 master parameters, BN buffers,
    the optimizer's moments and counts, the step) as one ``torch.save`` in
    ``ckpt_dir/step_{step}/state.pt``, then keep only the newest ``keep``
    step directories. Returns the directory. In a process group every rank
    calls it (the state is a collective under ZeRO); rank 0 writes the same
    file as a single process, and every rank leaves after it is written."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    state = trainer.state_dict()
    if is_main():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CKPT_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, CKPT_FILE))
        _prune(ckpt_dir, keep)
    barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_dirs(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1][1]) if steps else None


def load_train_checkpoint(path: str) -> Dict[str, Any]:
    """A ``step_{n}`` directory or its file -> the saved dict, on the CPU
    (``torch.load(weights_only=True)``: tensors and plain containers only)."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_params(path: str) -> Dict[str, torch.Tensor]:
    """The model's state_dict (parameters and BN buffers) of a train
    checkpoint, without its optimizer: what evaluation needs."""
    return load_train_checkpoint(path)["model"]


def restore_checkpoint(path: str, trainer) -> None:
    """Load a train checkpoint into ``trainer`` (model, optimizer, step)."""
    trainer.load_state_dict(load_train_checkpoint(path))


def _prune(ckpt_dir: str, keep: int) -> None:
    for _, d in _step_dirs(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
