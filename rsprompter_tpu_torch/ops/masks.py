"""GT mask unpacking, and mask post-processing: u8 quantise -> resize ->
crop -> resize -> threshold.

Counterpart of ``rsprompter_tpu/ops/masks.py`` (``unpack_bits`` :22,
``unpack_batch_masks`` :37, and the u8 transfer path):
sigmoid 256^2 masks are quantised to uint8 (``quantize_probs_u8``), then
bilinearly resized to the padded batch input shape, cropped to the region the
keep-ratio resize filled, resized to the original image shape and
thresholded. :func:`finalize_masks_np` is the numpy version kept from the
JAX package; :func:`finalize_masks` runs the same chain on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rsprompter_tpu_torch.ops.resize import resize


def unpack_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """The inverse of ``np.packbits(axis=-1)`` (MSB first) on the tensor's
    device: (..., ceil(W/8)) uint8 -> (..., W) float32 in {0, 1}."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits[..., :width].float()


def unpack_batch_masks(batch: dict) -> dict:
    """Replace ``gt_masks_packed`` with unpacked ``gt_masks`` (the batch as
    it is if it already carries raw masks); masks are padded to the image
    width."""
    if "gt_masks_packed" not in batch:
        return batch
    batch = dict(batch)
    packed = batch.pop("gt_masks_packed")
    batch["gt_masks"] = unpack_bits(packed, batch["images"].shape[-2])
    return batch


def quantize_probs_u8(probs: torch.Tensor) -> torch.Tensor:
    return torch.round(probs * 255.0).to(torch.uint8)


def probs_to_f32(probs):
    """uint8 (quantize_probs_u8) -> fp32 in [0, 1]; floats pass as fp32."""
    if isinstance(probs, torch.Tensor):
        return probs.float() / 255.0 if probs.dtype == torch.uint8 else probs.float()
    probs = np.asarray(probs)
    if probs.dtype == np.uint8:
        return probs.astype(np.float32) / 255.0
    return probs.astype(np.float32)


def upsample_masks(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize`` bilinear of (..., h, w) masks to (..., H, W)."""
    return resize(masks, masks.shape[:-2] + tuple(size), "bilinear")


# masks per step of _np_bilinear_resize: a few 1024^2 fp32 masks stay in cache
_RESIZE_CHUNK = 4


def _np_bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """align_corners=False bilinear resize for (N, H, W) numpy stacks.

    The JAX package's arithmetic, term by term in the same order and in
    fp32 (so the same bits), with the gathers done one axis at a time and
    the stack taken ``_RESIZE_CHUNK`` masks at a time to stay in cache:
    several times faster at 100 masks of 1024^2."""
    n, h, w = img.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1).astype(np.float32)[None, :, None]
    wx = np.clip(xs - x0, 0, 1).astype(np.float32)[None, None, :]
    vy, vx = 1 - wy, 1 - wx
    out = np.empty((n, out_h, out_w), np.result_type(img.dtype, np.float32))
    for s in range(0, n, _RESIZE_CHUNK):
        part = img[s:s + _RESIZE_CHUNK]
        r0, r1 = part.take(y0, axis=1), part.take(y1, axis=1)
        acc = out[s:s + _RESIZE_CHUNK]
        # p00 (1-wy)(1-wx) + p01 (1-wy) wx + p10 wy (1-wx) + p11 wy wx
        np.multiply(r0.take(x0, axis=2), vy, out=acc)
        acc *= vx
        for rows, cols, a, b in ((r0, x1, vy, wx), (r1, x0, wy, vx), (r1, x1, wy, wx)):
            t = rows.take(cols, axis=2)
            t *= a
            t *= b
            acc += t
    return out


def finalize_masks_np(
    mask_probs: np.ndarray,  # (N, S, S) low-res full-frame probs (u8 or float)
    batch_input_shape: Tuple[int, int],
    ori_shape: Tuple[int, int],
    scale_factor: Tuple[float, float],  # (w_scale, h_scale)
    thr: float = 0.5,
) -> np.ndarray:
    """Host-side finalisation to original-resolution binary masks."""
    in_h, in_w = batch_input_shape
    ori_h, ori_w = ori_shape
    w_scale, h_scale = scale_factor
    up = _np_bilinear_resize(probs_to_f32(mask_probs), in_h, in_w)
    up = up[:, : int(ori_h * h_scale), : int(ori_w * w_scale)]
    out = _np_bilinear_resize(up, ori_h, ori_w)
    if thr >= 0:
        return out >= thr
    return (out * 255).astype(np.uint8)


def _bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W) -> (N, h, w), align_corners=False, no antialias: the same
    sampling as ``_np_bilinear_resize``."""
    if x.shape[0] == 0:
        return x.new_zeros((0,) + tuple(size))
    return F.interpolate(x[:, None], size=tuple(size), mode="bilinear",
                         align_corners=False)[:, 0]


def finalize_masks(
    mask_probs: torch.Tensor,  # (N, S, S) u8 or float, on any device
    batch_input_shape: Tuple[int, int],
    ori_shape: Tuple[int, int],
    scale_factor: Tuple[float, float],
    thr: float = 0.5,
) -> torch.Tensor:
    """:func:`finalize_masks_np` on the tensor's device."""
    ori_h, ori_w = ori_shape
    w_scale, h_scale = scale_factor
    up = _bilinear(probs_to_f32(mask_probs), batch_input_shape)
    up = up[:, : int(ori_h * h_scale), : int(ori_w * w_scale)]
    out = _bilinear(up.contiguous(), (ori_h, ori_w))
    if thr >= 0:
        return out >= thr
    return (out * 255).to(torch.uint8)
