"""Python API: ``init_detector`` / ``inference_detector`` / ``DetInferencer``.

Counterpart of ``rsprompter_tpu/apis/inference.py`` and
``rsprompter_tpu/apis/inferencer.py``: build and load once, infer many.
``DetInferencer`` takes image paths (read by ``data.io.imread``: PNG, and
JPEG through the port's own decoder) and arrays; with ``size_buckets`` each
chunk of ``batch_size`` inputs runs at the smallest square bucket that fits
all its images (JAX ``:102-107``, ``:234-238``); with ``out_dir`` it writes
one drawing per input (``apis.visualization``) under JAX's names -- a path's
basename (JPEG at OpenCV's default quality 95 through the port's encoder for
``.jpg`` / ``.jpeg``, PNG for ``.png``, ``.png`` put in place of any other
extension), ``img_{n}.jpg`` for the n-th array -- and ``predictions.json``
without masks. With ``tta`` set (``models.tta.make_tta_predict``'s
predict) every batch runs with flip TTA inside ``predict_tensors``, which
``oom_guard`` wraps, as JAX's test tool wraps its ``tta_fn``.
One lock is held around each chunk's predict and its host copies, so that
threads sharing an inferencer (the server's bucket workers) do not
interleave launches, host syncs and the kernels' launch counts on the one
card. Masks come to the host as uint8 probabilities only (ROADMAP, "Do not
port": ``flat``, ``bits``, dispatch-ahead), so JAX's ``mask_transfer`` is
no parameter here; nor is ``exported``, as the StableHLO export is not
ported (passing either raises ``TypeError``). The test pipeline is the JAX
package's -- keep-ratio resize into the crop, pad with the BGR ImageNet
mean, uint8 BGR batch -- with OpenCV's float INTER_LINEAR rebuilt in torch
on the device (``ops.image``), since the card's machine has no OpenCV, and
rounded to uint8 as JAX's ``PackDetInputs`` rounds it.
Post-processing is the u8 mask chain, run on the device, for the families
whose masks cover the whole frame; SAM-seg Mask R-CNN's 28^2 RoI masks are
pasted into their boxes instead (``mask_mode`` 'paste', mmdet's
``_do_paste_mask``), on the host. JAX's inferencer and test tool send those
RoI maps through the full-frame chain, which stretches each over the whole
image: a fault of the reference package the port does not share.

With ``oracle`` set (SAM-det's ``oracle_predict``) a batch also carries each
image's ground truth in batch-input pixels, ``max_gt`` slots an image, as
JAX's test pipeline gives it.

Entry points run on the card unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rsprompter_tpu_torch.apis.build import (
    build_detector,
    init_random_weights,
    set_compute_dtype,
)
from rsprompter_tpu_torch.apis.visualization import draw_predictions
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.data.io import drawn_name, imread, imwrite
from rsprompter_tpu_torch.engine.checkpoint import load_config_sam, load_torch_checkpoint
from rsprompter_tpu_torch.models.roi_heads.mask_head import paste_masks_np
from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2
from rsprompter_tpu_torch.ops.masks import finalize_masks, probs_to_f32, quantize_probs_u8
from rsprompter_tpu_torch.utils.memory import oom_guard

# pad applied while the image is still BGR (reference test pipeline)
PAD_VALUE_BGR = (0.406 * 255, 0.456 * 255, 0.485 * 255)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def mask_mode_of(model: torch.nn.Module) -> str:
    """'paste' for a detector whose masks are RoI maps over their boxes
    (SAM-seg Mask R-CNN), else 'fullframe'."""
    return getattr(model, "mask_mode", "fullframe")


def _target_size(h: int, w: int, crop):
    th, tw = crop
    r = min(th / h, tw / w)
    return max(int(h * r + 0.5), 1), max(int(w * r + 0.5), 1)


class DetInferencer:
    """Config + weights -> callable ``images -> predictions``.

    ``size_buckets``: square input sizes; each chunk runs at the smallest
    that holds the longest side of every image in it (the largest where none
    does); without buckets, at the config's ``crop_size``."""

    def __init__(
        self,
        model: Union[str, Dict[str, Any], Config],
        weights: Optional[Union[str, Dict[str, torch.Tensor]]] = None,
        device: Union[str, torch.device] = "cuda",
        batch_size: int = 2,
        seed: int = 0,
        size_buckets: Optional[Sequence[int]] = None,
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
        self.size_buckets = sorted(size_buckets) if size_buckets else None
        self.batch_size = batch_size
        self.weights = weights
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
        self.mask_mode = mask_mode_of(self.model)
        self.max_gt = cfg.get("max_gt", 100)
        self.oracle = False  # oracle_predict: ground-truth boxes as prompts
        self.tta: Optional[Callable] = None  # make_tta_predict's predict
        self._lock = threading.Lock()

    @classmethod
    def from_module(cls, model: torch.nn.Module, cfg: Config, batch_size: int = 2):
        """An inferencer over a detector that already exists, on its device
        and in its dtypes (the train runner's validation: the trainer's
        fp32 master parameters, cast at each use). The caller sets its
        train / eval mode."""
        self = cls.__new__(cls)
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.crop_size = tuple(cfg.get("crop_size", (1024, 1024)))
        self.size_buckets = None
        self.batch_size = batch_size
        self.weights = None
        self.model = model
        self.mask_mode = mask_mode_of(model)
        self.max_gt = cfg.get("max_gt", 100)
        self.oracle = False
        self.tta = None
        self._lock = threading.Lock()
        return self

    def _bucket_for(self, h: int, w: int) -> Tuple[int, int]:
        if not self.size_buckets:
            return self.crop_size
        for b in self.size_buckets:
            if max(h, w) <= b:
                return (b, b)
        return (self.size_buckets[-1], self.size_buckets[-1])

    def verify_weights(self) -> None:
        """Read the config's SAM file (where it exists) and ``weights`` (where
        a path) on the host, raising on one that cannot be read: a server
        checks them before it binds its port."""
        mcfg = self.cfg["model"]
        sam = mcfg.get("hf_sam_pretrain_ckpt_path") or mcfg.get("sam_checkpoint")
        if sam and os.path.exists(sam):
            load_torch_checkpoint(sam)
        if isinstance(self.weights, str):
            torch.load(self.weights, map_location="cpu")

    def make_batch(self, imgs: Sequence[np.ndarray], metas: Optional[Sequence[Dict]] = None,
                   gts: Optional[Sequence[Dict]] = None, crop: Optional[Tuple[int, int]] = None):
        """HWC BGR images -> (batch dict on the device, per-slot metas), at
        ``crop`` (default the config's ``crop_size``).

        ``metas`` (the loader's, one per slot, padded slots marked
        ``img_id=-1``) are merged into the geometry metas; a padded slot
        takes the last image's geometry, as JAX's ``collate_batch`` does.
        ``gts`` (one raw sample per image: ``gt_bboxes`` at the original
        size, ``gt_labels``, ``gt_ignore_flags``) add ``gt_bboxes`` in
        batch-input pixels, ``gt_labels`` and ``gt_valid`` (not ignored),
        ``max_gt`` slots an image."""
        for item in imgs:
            if not isinstance(item, np.ndarray):
                raise TypeError("the predict takes HWC uint8 BGR numpy arrays (or, through "
                                "DetInferencer, image paths)")
        crop = tuple(crop or self.crop_size)
        th, tw = crop
        n = self.batch_size
        images = torch.empty((n, th, tw, 3), dtype=torch.uint8, device=self.device)
        images[...] = torch.tensor(np.round(PAD_VALUE_BGR), dtype=torch.uint8)
        img_shape = torch.zeros((n, 2), dtype=torch.int32)
        out = []
        for i, img in enumerate(imgs):
            h, w = img.shape[:2]
            nh, nw = _target_size(h, w, crop)
            x = torch.as_tensor(np.ascontiguousarray(img), device=self.device)
            x = resize_bilinear_cv2(x, (nh, nw))
            images[i, :nh, :nw] = x.round().clamp(0, 255).to(torch.uint8)
            img_shape[i] = torch.tensor([nh, nw])
            out.append(dict(ori_shape=(h, w), img_shape=(nh, nw),
                            scale_factor=(nw / w, nh / h), batch_input_shape=(th, tw)))
        if metas is not None:
            out += [dict(out[-1]) for _ in range(len(metas) - len(out))]
            out = [dict(m, **given) for m, given in zip(out, metas)]
        batch = dict(images=images, img_shape=img_shape.to(self.device))
        if gts is not None:
            batch.update(self._gt_batch(gts, out))
        return batch, out

    def _gt_batch(self, gts: Sequence[Dict], metas: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        g_max = self.max_gt
        boxes = np.zeros((self.batch_size, g_max, 4), np.float32)
        labels = np.zeros((self.batch_size, g_max), np.int64)
        valid = np.zeros((self.batch_size, g_max), bool)
        for i, (gt, meta) in enumerate(zip(gts, metas)):
            g = min(len(gt["gt_bboxes"]), g_max)
            ws, hs = meta["scale_factor"]
            boxes[i, :g] = gt["gt_bboxes"][:g] * np.array([ws, hs, ws, hs], np.float32)
            labels[i, :g] = gt["gt_labels"][:g]
            valid[i, :g] = ~np.asarray(gt["gt_ignore_flags"][:g], bool)
        return {k: torch.as_tensor(v, device=self.device) for k, v in
                dict(gt_bboxes=boxes, gt_labels=labels, gt_valid=valid).items()}

    def predict_tensors(self, batch: Dict[str, torch.Tensor]):
        """``make_batch``'s batch -> ``(dets, probs_u8)`` on the device: every
        slot's detections (``dets.valid`` marks the kept ones) and its uint8
        mask probabilities at the decoder's resolution (full frame, or each
        detection's box in 'paste' mode), as JAX's ``tools/test.py`` hands
        them to ``CocoMetric``. With ``oracle`` set the batch's ground truth
        prompts SAM; with ``tta`` set the batch and its mirror are predicted
        and merged. This is what ``oom_guard`` wraps."""
        if self.oracle:
            if "gt_bboxes" not in batch:
                raise ValueError("oracle prediction needs the images' ground truth (gts)")
            dets, probs = self.model.oracle_predict(batch)
        elif self.tta is not None:
            dets, probs = self.tta(batch)
        else:
            dets, probs = self.model.predict(batch)
        return dets, quantize_probs_u8(probs)

    def predict_batch(self, imgs: Sequence[np.ndarray], metas: Optional[Sequence[Dict]] = None,
                      gts: Optional[Sequence[Dict]] = None, crop: Optional[Tuple[int, int]] = None):
        """Up to ``batch_size`` images -> the padded ``(dets, probs_u8,
        metas)`` on the device: ``predict_tensors`` on ``make_batch``'s
        batch, under ``oom_guard`` (a batch that runs the card out of memory
        is halved, as JAX's test tool and validation guard their predict;
        ``evaluation.loop.evaluate`` predicts through here)."""
        batch, metas = self.make_batch(imgs, metas, gts if self.oracle else None, crop)
        dets, probs_u8 = oom_guard(self.predict_tensors)(batch)
        return dets, probs_u8, metas

    def _finish(self, dets, probs_u8, i: int, meta: Dict, return_masks: bool,
                score_thr: float) -> Dict[str, Any]:
        """Slot ``i``'s kept detections on the host, at the original size."""
        keep = dets.valid[i] & (dets.scores[i] > score_thr)
        ws, hs = meta["scale_factor"]
        scale = torch.tensor([ws, hs, ws, hs], device=self.device)
        pred = dict(
            bboxes=(dets.boxes[i][keep] / scale).cpu().numpy(),
            scores=dets.scores[i][keep].cpu().numpy(),
            labels=dets.labels[i][keep].cpu().numpy(),
        )
        if return_masks and self.mask_mode == "paste":
            pred["masks"] = paste_masks_np(
                probs_to_f32(probs_u8[i][keep].cpu().numpy()), pred["bboxes"],
                *meta["ori_shape"])
        elif return_masks:
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
        return pred

    def __call__(self, inputs, out_dir: Optional[str] = None, return_masks: bool = True,
                 score_thr: float = 0.0) -> Dict[str, Any]:
        """Image paths and / or HWC BGR arrays (one, or a list) -> {'predictions':
        one dict a input (``bboxes`` xyxy at the input's size, ``scores``,
        ``labels``, ``masks`` (N, H, W) bool)}; with ``out_dir``, a drawn PNG
        a input and ``predictions.json`` there."""
        if isinstance(inputs, (str, os.PathLike)) or (
                isinstance(inputs, np.ndarray) and inputs.ndim == 3):
            inputs = [inputs]
        predictions: List[Dict[str, Any]] = []
        for start in range(0, len(inputs), self.batch_size):
            chunk = inputs[start : start + self.batch_size]
            imgs = [imread(os.fspath(x)) if isinstance(x, (str, os.PathLike)) else x
                    for x in chunk]
            # one bucket a chunk, the smallest that fits every image in it
            side = max(max(im.shape[0], im.shape[1]) for im in imgs)
            crop = self._bucket_for(side, side)
            with self._lock:
                dets, probs_u8, metas = self.predict_batch(imgs, crop=crop)
                preds = [self._finish(dets, probs_u8, i, meta, return_masks, score_thr)
                         for i, meta in enumerate(metas)]
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                for i, (item, img, pred) in enumerate(zip(chunk, imgs, preds)):
                    name = (drawn_name(item) if isinstance(item, (str, os.PathLike))
                            else f"img_{start + i}.jpg")
                    imwrite(os.path.join(out_dir, name), draw_predictions(img, pred))
            predictions.extend(preds)
        if out_dir:
            dumpable = [{k: np.asarray(v).tolist() for k, v in p.items() if k != "masks"}
                        for p in predictions]
            with open(os.path.join(out_dir, "predictions.json"), "w") as f:
                json.dump(dumpable, f)
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
