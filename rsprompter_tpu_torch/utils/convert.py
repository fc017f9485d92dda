"""JAX (flax) variables -> the port's ``state_dict``.

Input: the JAX model's variables as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}``. Output: a flat ``state_dict`` of
torch tensors that ``load_state_dict(strict=True)`` accepts on the port's
modules, whose attribute names mirror the flax paths.

Key and layout rules (the port's own copy of those in the JAX package's
torch converter):

  flax leaf                  torch tensor                 transform
  -------------------------  ---------------------------  -------------------
  kernel (2-D)               Linear.weight (out, in)      transpose
  kernel (4-D)               Conv2d.weight (O, I, kh, kw)  HWIO -> OIHW
  kernel (4-D, ConvTranspose ConvTranspose2d.weight       spatial flip,
    hint in the path)          (I, O, kh, kw)               HWIO -> IOHW
  scale / embedding          .weight                      as is
  mean / var (batch_stats)   .running_mean / .running_var as is
  anything else              same name                    as is
    (the LoRA adapters ``qkv_lora_a`` (C, r) and ``qkv_lora_b`` (r, 3C)
    keep JAX's layout and names)

Module names ``layers_3`` become ``layers.3`` (every trailing ``_N`` is an
index) and flax's ``bn`` wrapper level disappears. The two linears fed by a
flattened conv map (``shared_fcs_0`` and the anchor head's ``point_emb_4``)
flatten NHWC in JAX and NCHW in the port, so their input columns are
permuted.

The query head's pixel decoder and transformer decoder, SAM-det's FPN and
the FCN mask head take the reference's mmdet module names
(``MODULE_RENAMES``): ``input_convs_0_conv`` -> ``input_convs.0.conv``
beside ``input_convs.0.gn`` (FPN ``lateral_convs_0_conv`` /
``fpn_convs_0_conv``, the mask head's ``convs_0_conv`` alike), ``encoder_layers_0`` ->
``encoder.layers.0``, ``transformer_decoder_layers_0`` ->
``transformer_decoder.layers.0``; the per-level ``level_encoding_i`` vectors
stack into the rows of ``level_encoding.weight`` (an ``nn.Embedding``).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LIST_SUFFIX = re.compile(r"^(.*?)((?:_\d+)+)$")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "mean": "running_mean", "var": "running_var"}
# flax path substrings whose 4-D kernels are ConvTranspose2d weights
TRANSPOSE_CONV_HINTS = ("upscale_conv", "deconv", "fpn1_0", "fpn1_3", "fpn2_0", "upsample")
# linears whose input is a flattened (C, H, W) conv map: name -> C (the
# query head's point_emb_4 takes query vectors, not a map)
FLATTEN_LINEARS = {"shared_fcs_0": 256, "point_emb_4": 256}
FLATTEN_EXCEPT = "panoptic_head"
# flax module name -> the mmdet module path of the query head
MODULE_RENAMES = (
    (re.compile(r"^((?:input|lateral|output|fpn)_)?convs_(\d+)_conv$"), r"\1convs.\2.conv"),
    (re.compile(r"^(encoder|transformer_decoder)_layers_(\d+)$"), r"\1.layers.\2"),
    (re.compile(r"^transformer_decoder_post_norm$"), "transformer_decoder.post_norm"),
)
LEVEL_ENCODING = re.compile(r"^level_encoding_(\d+)$")


def _expand_indices(name: str) -> str:
    m = _LIST_SUFFIX.match(name)
    if not m:
        return name
    return m.group(1) + m.group(2).replace("_", ".")


def _module_name(name: str) -> str:
    for pattern, repl in MODULE_RENAMES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return _expand_indices(name)


def torch_key(path: Tuple[str, ...]) -> str:
    parts = [_module_name(p) for p in path[:-1] if p != "bn"]
    parts.append(_LEAF_NAMES.get(path[-1], path[-1]))
    return ".".join(parts)


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return arr
    if arr.ndim == 2:
        out = arr.T  # (out, in)
        channels = next(
            (c for name, c in FLATTEN_LINEARS.items()
             if name in path and FLATTEN_EXCEPT not in path), None
        )
        if channels is not None:
            o, n_in = out.shape
            hw = int(math.isqrt(n_in // channels))
            out = (
                out.reshape(o, hw, hw, channels).transpose(0, 3, 1, 2).reshape(o, n_in)
            )
        return out
    if arr.ndim == 4:
        if any(h in p for p in path for h in TRANSPOSE_CONV_HINTS):
            return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"unhandled kernel rank {arr.ndim} at {'/'.join(path)}")


def jax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested {'params': ..., 'batch_stats': ...} numpy dicts -> state_dict."""
    out: Dict[str, torch.Tensor] = {}
    levels: Dict[str, Dict[int, np.ndarray]] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        m = LEVEL_ENCODING.match(path[-1])
        if m:
            key = torch_key(path[:-1] + ("level_encoding", "embedding"))
            levels.setdefault(key, {})[int(m.group(1))] = np.asarray(node, np.float32)
            return
        arr = _convert_leaf(path, np.asarray(node, dtype=np.float32))
        key = torch_key(path)
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        if key.endswith(".running_mean"):
            out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)

    for collection in ("params", "batch_stats"):
        if collection in variables:
            walk(variables[collection], ())
    for key, rows in levels.items():
        out[key] = torch.from_numpy(np.stack([rows[i] for i in range(len(rows))]))
    return out
