"""Python API: ``init_detector`` / ``inference_detector`` (torch port).

Counterpart of ``rsprompter_tpu/apis/inference.py`` and the predict path of
``rsprompter_tpu/apis/inferencer.py``: build and load once, infer many. The
test pipeline is the JAX package's -- keep-ratio resize into the crop, pad
with the BGR ImageNet mean, uint8 BGR batch -- with OpenCV's float
INTER_LINEAR rebuilt in torch on the device (``ops.image``), since the
card's machine has no OpenCV, and rounded to uint8 as JAX's
``PackDetInputs`` rounds it.
Post-processing is the u8 mask chain, run on the device.

Entry points run on the card unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from rsprompter_tpu_torch.apis.build import (
    build_detector,
    init_random_weights,
    set_compute_dtype,
)
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.engine.checkpoint import load_config_sam
from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2
from rsprompter_tpu_torch.ops.masks import finalize_masks, quantize_probs_u8

# pad applied while the image is still BGR (reference test pipeline)
PAD_VALUE_BGR = (0.406 * 255, 0.456 * 255, 0.485 * 255)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def _target_size(h: int, w: int, crop):
    th, tw = crop
    r = min(th / h, tw / w)
    return max(int(h * r + 0.5), 1), max(int(w * r + 0.5), 1)


class DetInferencer:
    """Config + weights -> callable ``images -> predictions``."""

    def __init__(
        self,
        model: Union[str, Dict[str, Any], Config],
        weights: Optional[Union[str, Dict[str, torch.Tensor]]] = None,
        device: Union[str, torch.device] = "cuda",
        batch_size: int = 2,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if isinstance(model, (str, os.PathLike)):
            cfg = Config.fromfile(model)
        elif isinstance(model, Config):
            cfg = model
        else:  # a whole config dict, or just its ``model`` entry
            cfg = Config.fromdict(model if "model" in model else {"model": model})
        self.cfg = cfg
        self.crop_size = tuple(cfg.get("crop_size", (1024, 1024)))
        self.batch_size = batch_size
        self.model = build_detector(cfg["model"])
        if weights is None:
            init_random_weights(self.model, seed)
            load_config_sam(self.model, cfg["model"])  # where the config's file exists
        else:  # a full state_dict wins, as JAX restores it after the SAM load
            sd = torch.load(weights, map_location="cpu") if isinstance(weights, str) else weights
            self.model.load_state_dict(sd, strict=True)
        if cfg["model"].get("bf16", False):
            set_compute_dtype(self.model, torch.bfloat16)
        self.model.to(self.device).eval()

    def make_batch(self, imgs: Sequence[np.ndarray], metas: Optional[Sequence[Dict]] = None):
        """HWC BGR images -> (batch dict on the device, per-slot metas).

        ``metas`` (the loader's, one per slot, padded slots marked
        ``img_id=-1``) are merged into the geometry metas; a padded slot
        takes the last image's geometry, as JAX's ``collate_batch`` does."""
        th, tw = self.crop_size
        n = self.batch_size
        images = torch.empty((n, th, tw, 3), dtype=torch.uint8, device=self.device)
        images[...] = torch.tensor(np.round(PAD_VALUE_BGR), dtype=torch.uint8)
        img_shape = torch.zeros((n, 2), dtype=torch.int32)
        out = []
        for i, img in enumerate(imgs):
            h, w = img.shape[:2]
            nh, nw = _target_size(h, w, self.crop_size)
            x = torch.as_tensor(np.ascontiguousarray(img), device=self.device)
            x = resize_bilinear_cv2(x, (nh, nw))
            images[i, :nh, :nw] = x.round().clamp(0, 255).to(torch.uint8)
            img_shape[i] = torch.tensor([nh, nw])
            out.append(dict(ori_shape=(h, w), img_shape=(nh, nw),
                            scale_factor=(nw / w, nh / h), batch_input_shape=(th, tw)))
        if metas is not None:
            out += [dict(out[-1]) for _ in range(len(metas) - len(out))]
            out = [dict(m, **given) for m, given in zip(out, metas)]
        return dict(images=images, img_shape=img_shape.to(self.device)), out

    def predict_batch(self, imgs: Sequence[np.ndarray], metas: Optional[Sequence[Dict]] = None):
        """Up to ``batch_size`` images -> the padded ``(dets, probs_u8,
        metas)`` on the device: every slot's detections (``dets.valid`` marks
        the kept ones) and its uint8 mask probabilities at the decoder's
        resolution, as JAX's ``tools/test.py`` hands them to ``CocoMetric``."""
        for item in imgs:
            if not isinstance(item, np.ndarray):
                raise TypeError("inference_detector takes HWC uint8 BGR numpy arrays")
        batch, metas = self.make_batch(imgs, metas)
        dets, probs = self.model.predict(batch)
        return dets, quantize_probs_u8(probs), metas

    def __call__(self, inputs, return_masks: bool = True, score_thr: float = 0.0):
        if isinstance(inputs, np.ndarray) and inputs.ndim == 3:
            inputs = [inputs]
        predictions: List[Dict[str, Any]] = []
        for start in range(0, len(inputs), self.batch_size):
            dets, probs_u8, metas = self.predict_batch(inputs[start : start + self.batch_size])
            for i, meta in enumerate(metas):
                keep = dets.valid[i] & (dets.scores[i] > score_thr)
                ws, hs = meta["scale_factor"]
                scale = torch.tensor([ws, hs, ws, hs], device=self.device)
                pred = dict(
                    bboxes=(dets.boxes[i][keep] / scale).cpu().numpy(),
                    scores=dets.scores[i][keep].cpu().numpy(),
                    labels=dets.labels[i][keep].cpu().numpy(),
                )
                if return_masks:
                    masks = finalize_masks(
                        probs_u8[i][keep], meta["batch_input_shape"],
                        meta["ori_shape"], meta["scale_factor"],
                    )
                    # original-resolution masks are the largest transfer of
                    # predict; a pinned buffer copies several times faster
                    # than pageable memory
                    host = torch.empty(masks.shape, dtype=masks.dtype,
                                       pin_memory=masks.is_cuda)
                    pred["masks"] = host.copy_(masks).numpy()
                predictions.append(pred)
        return {"predictions": predictions}


def init_detector(
    config: Union[str, Dict[str, Any], Config],
    checkpoint: Optional[Union[str, Dict[str, torch.Tensor]]] = None,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
) -> DetInferencer:
    """Build a ready-to-run detector: seeded random weights, the SAM
    subtrees from the config's ``hf_sam_pretrain_ckpt_path`` where that file
    exists, then ``checkpoint`` (a saved ``state_dict`` path or a
    ``state_dict``) over all of it where one is given."""
    return DetInferencer(config, weights=checkpoint, device=device, **kwargs)


def inference_detector(model: DetInferencer, imgs, **kwargs):
    """Run inference; returns the per-image prediction dicts."""
    return model(imgs, **kwargs)["predictions"]
