"""Test-time augmentation: horizontal-flip TTA for any detector.

Counterpart of ``rsprompter_tpu/models/tta.py`` (``hflip_batch`` :33,
``make_tta_predict`` :48), the reference's ``DetTTAModel`` behind
``tools/test.py --tta``: predict on the batch and on its mirror, map the
mirrored detections back, and run per-class NMS over the union of the two,
keeping ``max_per_img``.

The batch is already padded bottom-right, so the mirror flips each image's
valid region in place and leaves the padding on the right, as the
reference's resize -> flip -> pad pipeline has it. Every image's shift is
index arithmetic on the device, one gather for the batch.

Full-frame masks are mirrored and shifted back by their raster's stride,
``round(w_valid / stride) - w_mask`` columns as JAX does (within half a
stride of the image's own pixels). RoI masks ('paste' mode, SAM-seg Mask
R-CNN's 28 x 28 maps over their boxes) are mirrored only: the box is mirrored
already, and a map is the box's content. JAX shifts them as if they covered
the frame, which moves each map within its box: a fault of the reference
package the port does not share.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
from rsprompter_tpu_torch.ops.nms import batched_nms


def tta_settings(cfg) -> Dict[str, Any]:
    """``iou_thr`` and ``max_per_img`` of the merge, from the config's
    ``model.test_cfg.rcnn`` (0.5 and 100 where absent), as JAX's test tool
    takes them."""
    rcnn = dict((cfg["model"].get("test_cfg") or {}).get("rcnn", {}) or {})
    return dict(iou_thr=rcnn.get("nms_iou_thr", 0.5), max_per_img=rcnn.get("max_per_img", 100))


def _mirror_index(width: int, w_valid: torch.Tensor) -> torch.Tensor:
    """(B, width) source column of each output column: the first
    ``w_valid`` columns mirrored, the rest of the row after them (the
    flipped row rolled left by the padding)."""
    j = torch.arange(width, device=w_valid.device)
    return width - 1 - torch.remainder(j[None] - w_valid[:, None], width)


def hflip_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch with each image's valid region mirrored inside the padded
    canvas, the padding kept on the right."""
    images = batch["images"]  # (B, H, W, C)
    src = _mirror_index(images.shape[2], batch["img_shape"][:, 1].long())
    out = dict(batch)
    out["images"] = torch.gather(images, 2, src[:, None, :, None].expand(images.shape))
    return out


def merge_views(batch: Dict[str, torch.Tensor], view: Tuple[DetResult, torch.Tensor],
                mirrored: Tuple[DetResult, torch.Tensor], *, iou_thr: float = 0.5,
                max_per_img: int = 100, paste: bool = False
                ) -> Tuple[DetResult, torch.Tensor]:
    """``model.predict``'s output on ``batch`` and on ``hflip_batch(batch)``
    -> the merged ``(DetResult, mask_probs)``: the mirrored detections mapped
    back, both sets through per-class NMS, ``min(max_per_img, 2 N)`` slots
    an image."""
    dets_i, probs_i = view
    dets_f, probs_f = mirrored
    w_valid = batch["img_shape"][:, 1]
    wv = w_valid.to(dets_f.boxes.dtype)[:, None]
    bx = dets_f.boxes
    boxes_f = torch.stack([wv - bx[..., 2], bx[..., 1], wv - bx[..., 0], bx[..., 3]], -1)
    w_mask = probs_f.shape[-1]
    if paste:
        probs_f = probs_f.flip(-1)
    else:  # mirror the raster, then shift its padding back to the right
        stride = batch["images"].shape[2] / w_mask
        shift = torch.round(w_valid.float() / stride).long() - w_mask  # (B,)
        j = torch.arange(w_mask, device=probs_f.device)
        src = w_mask - 1 - torch.remainder(j[None] - shift[:, None], w_mask)  # (B, w)
        probs_f = torch.gather(probs_f, -1, src[:, None, None, :].expand(probs_f.shape))

    boxes = torch.cat([dets_i.boxes, boxes_f], 1)
    scores = torch.cat([dets_i.scores, dets_f.scores], 1)
    labels = torch.cat([dets_i.labels, dets_f.labels], 1)
    valid = torch.cat([dets_i.valid, dets_f.valid], 1)
    probs = torch.cat([probs_i, probs_f], 1)
    idx, keep, out_boxes, out_scores = batched_nms(
        boxes, scores, labels, iou_thr=iou_thr, max_out=max_per_img, valid=valid)
    b, k = idx.shape
    out_labels = torch.gather(labels, 1, idx)
    out_probs = torch.gather(probs, 1, idx[:, :, None, None].expand(b, k, *probs.shape[2:]))
    return DetResult(out_boxes, out_scores, out_labels, keep), out_probs


def make_tta_predict(model: torch.nn.Module, *, iou_thr: float = 0.5,
                     max_per_img: int = 100) -> Callable:
    """``batch -> (DetResult, mask_probs)`` with flip TTA: the shapes of
    ``model.predict``'s output with ``min(max_per_img, 2 N)`` detections an
    image."""
    paste = getattr(model, "mask_mode", "fullframe") == "paste"

    def predict(batch: Dict[str, torch.Tensor]) -> Tuple[DetResult, torch.Tensor]:
        return merge_views(batch, model.predict(batch), model.predict(hflip_batch(batch)),
                           iou_thr=iou_thr, max_per_img=max_per_img, paste=paste)

    return predict
