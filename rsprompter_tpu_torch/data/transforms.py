"""Host-side train and test transforms (numpy), and the GT collate.

Counterpart of ``rsprompter_tpu/data/transforms.py``: ``Resize`` :52,
``RandomResize`` :85, ``RandomFlip`` :104, ``RandomCrop`` :127,
``FilterAnnotations`` :168, ``Pad`` :188, ``PackDetInputs`` :214 (its
``normalize='device'`` path: uint8 BGR out), ``collate_batch`` :248 and the
two pipelines :327, :337. JAX resizes with OpenCV; the card's machine has
none, so:

- images go through the port's OpenCV-exact float bilinear scheme
  (``ops.image.resize_bilinear_cv2``) on a CPU tensor, and are rounded back
  to uint8 in ``PackDetInputs``, as JAX rounds them: after rounding a few
  pixels in 10^6 may differ from OpenCV's by one level;
- masks go through :func:`resize_masks_nearest`, pixel-equal to
  ``cv2.INTER_NEAREST``.

The random draws come from the ``rng`` a transform is given, else from the
global ``np.random``, in JAX's order: flip ``rand()``, then the resize's
``uniform``, then the crop's ``randint`` for y, then for x; so one seeded
``RandomState`` gives both packages the same sample.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2

# pad applied while the image is still BGR (reference test pipeline)
PAD_VALUE_BGR = (0.406 * 255, 0.456 * 255, 0.485 * 255)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST source index for each of ``n_out`` outputs:
    ``floor(d * ifx)`` with ``ifx = 1 / (n_out / n_in)`` in double, clamped
    to the last pixel (``resizeNN`` in imgproc/src/resize.cpp)."""
    ifx = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * ifx).astype(np.int64), n_in - 1)


def resize_masks_nearest(masks: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(m, (new_w, new_h), interpolation=INTER_NEAREST)`` of each
    (H, W) mask of an (N, H, W) stack, as uint8."""
    if masks.shape[0] == 0:
        return np.zeros((0, new_h, new_w), masks.dtype)
    ys = nearest_index(masks.shape[1], new_h)
    xs = nearest_index(masks.shape[2], new_w)
    return masks.astype(np.uint8, copy=False)[:, ys][:, :, xs]


def _resize_img(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """OpenCV's float INTER_LINEAR of an HWC image, as float32."""
    return resize_bilinear_cv2(torch.from_numpy(np.ascontiguousarray(img)),
                               (new_h, new_w)).numpy()


class Resize:
    """Keep-ratio resize to fit within ``scale`` (like mmdet Resize keep_ratio)."""

    def __init__(self, scale: Tuple[int, int], keep_ratio: bool = True):
        self.scale = scale  # (h, w) target
        self.keep_ratio = keep_ratio

    def _target(self, h, w):
        th, tw = self.scale
        if self.keep_ratio:
            r = min(th / h, tw / w)
            return max(int(h * r + 0.5), 1), max(int(w * r + 0.5), 1)
        return th, tw

    def __call__(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        h, w = sample["img"].shape[:2]
        nh, nw = self._target(h, w)
        ws, hs = nw / w, nh / h
        sample["img"] = _resize_img(sample["img"], nh, nw)
        sample["img_shape"] = (nh, nw)
        sample["scale_factor"] = (
            sample["scale_factor"][0] * ws, sample["scale_factor"][1] * hs
        )
        if len(sample.get("gt_bboxes", ())):
            sample["gt_bboxes"] = sample["gt_bboxes"] * np.array(
                [ws, hs, ws, hs], np.float32
            )
        if "gt_masks" in sample:
            sample["gt_masks"] = resize_masks_nearest(sample["gt_masks"], nh, nw)
        return sample


class RandomResize(Resize):
    """Large-scale jitter: sample ratio in ``ratio_range`` of ``scale``."""

    def __init__(self, scale, ratio_range=(0.1, 2.0), keep_ratio=True, rng=None):
        super().__init__(scale, keep_ratio)
        self.ratio_range = ratio_range
        self.rng = rng or np.random

    def _target(self, h, w):
        lo, hi = self.ratio_range
        ratio = self.rng.uniform(lo, hi)
        th, tw = int(self.scale[0] * ratio), int(self.scale[1] * ratio)
        if self.keep_ratio:
            r = min(th / h, tw / w)
            return max(int(h * r + 0.5), 1), max(int(w * r + 0.5), 1)
        return th, tw


class RandomFlip:
    def __init__(self, prob: float = 0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random

    def __call__(self, sample):
        if self.rng.rand() >= self.prob:
            return sample
        h, w = sample["img"].shape[:2]
        sample["img"] = sample["img"][:, ::-1].copy()
        if len(sample.get("gt_bboxes", ())):
            b = sample["gt_bboxes"]
            flipped = b.copy()
            flipped[:, 0] = w - b[:, 2]
            flipped[:, 2] = w - b[:, 0]
            sample["gt_bboxes"] = flipped
        if "gt_masks" in sample:
            sample["gt_masks"] = sample["gt_masks"][:, :, ::-1].copy()
        sample["flip"] = True
        return sample


class RandomCrop:
    """Absolute random crop; recomputes bboxes from cropped masks."""

    def __init__(self, crop_size: Tuple[int, int], recompute_bbox: bool = True,
                 allow_negative_crop: bool = True, rng=None):
        self.crop_size = crop_size
        self.recompute_bbox = recompute_bbox
        self.allow_negative_crop = allow_negative_crop
        self.rng = rng or np.random

    def __call__(self, sample):
        ch, cw = self.crop_size
        h, w = sample["img"].shape[:2]
        y0 = self.rng.randint(0, max(h - ch, 0) + 1)
        x0 = self.rng.randint(0, max(w - cw, 0) + 1)
        y1, x1 = min(y0 + ch, h), min(x0 + cw, w)
        sample["img"] = sample["img"][y0:y1, x0:x1]
        sample["img_shape"] = sample["img"].shape[:2]
        if len(sample.get("gt_bboxes", ())):
            b = sample["gt_bboxes"] - np.array([x0, y0, x0, y0], np.float32)
            masks = sample["gt_masks"][:, y0:y1, x0:x1]
            keep = masks.reshape(masks.shape[0], -1).sum(-1) > 0
            if self.recompute_bbox:
                nb = []
                for m in masks:
                    ys, xs = np.nonzero(m)
                    if len(ys):
                        nb.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                    else:
                        nb.append([0, 0, 0, 0])
                b = np.asarray(nb, np.float32).reshape(-1, 4)
            sample["gt_bboxes"] = b[keep]
            sample["gt_labels"] = sample["gt_labels"][keep]
            sample["gt_ignore_flags"] = sample["gt_ignore_flags"][keep]
            sample["gt_masks"] = masks[keep]
            if not keep.any() and not self.allow_negative_crop:
                return None
        return sample


class FilterAnnotations:
    def __init__(self, min_gt_bbox_wh=(1e-5, 1e-5), by_mask: bool = True):
        self.min_wh = min_gt_bbox_wh
        self.by_mask = by_mask

    def __call__(self, sample):
        if not len(sample.get("gt_bboxes", ())):
            return sample
        b = sample["gt_bboxes"]
        keep = (b[:, 2] - b[:, 0] > self.min_wh[0]) & (
            b[:, 3] - b[:, 1] > self.min_wh[1]
        )
        if self.by_mask and "gt_masks" in sample:
            keep &= sample["gt_masks"].reshape(len(b), -1).sum(-1) > 0
        for k in ("gt_bboxes", "gt_labels", "gt_ignore_flags", "gt_masks"):
            sample[k] = sample[k][keep]
        return sample


class Pad:
    """Pad image (and masks) to ``size`` bottom-right, BGR-mean pad value."""

    def __init__(self, size: Tuple[int, int], pad_val=PAD_VALUE_BGR):
        self.size = size
        self.pad_val = pad_val

    def __call__(self, sample):
        th, tw = self.size
        h, w = sample["img"].shape[:2]
        ph, pw = max(th - h, 0), max(tw - w, 0)
        if ph or pw:
            # float, as JAX's image is float32 from the decode on
            sample["img"] = np.pad(
                sample["img"].astype(np.float32, copy=False), ((0, ph), (0, pw), (0, 0)),
                constant_values=0,
            )
            sample["img"][h:, :, :] = self.pad_val
            sample["img"][:, w:, :] = self.pad_val
            if "gt_masks" in sample and sample["gt_masks"].size:
                sample["gt_masks"] = np.pad(
                    sample["gt_masks"], ((0, 0), (0, ph), (0, pw))
                )
        sample["pad_shape"] = (max(th, h), max(tw, w))
        return sample


class PackDetInputs:
    """The model-facing image as uint8 BGR (JAX's ``normalize='device'``:
    ``models.preprocess`` converts BGR -> RGB and normalises on the card)."""

    def __call__(self, sample):
        sample["img"] = np.ascontiguousarray(
            np.clip(np.round(sample["img"]), 0, 255)
        ).astype(np.uint8)
        return sample


def collate_batch(
    samples: Sequence[Dict[str, Any]],
    batch_size: Optional[int] = None,
    max_gt: int = 100,
    pad_shape: Optional[Tuple[int, int]] = None,
    pack_masks: bool = True,
) -> Tuple[Dict[str, np.ndarray], list]:
    """Pad samples into the fixed-size batch dict + host metas.

    Images and masks pad to a common shape (the canvas takes the BGR means,
    so it normalises to about 0), GT pads to ``max_gt`` with validity flags,
    metas stay on the host; a padded slot repeats the last meta with
    ``img_id=-1``. ``pack_masks`` ships ``gt_masks_packed``, bit-packed
    uint8 (``np.packbits`` on the last axis), which the train step unpacks
    on the device (``ops.masks.unpack_batch_masks``): at 512^2, batch 4,
    ``max_gt`` 100 that is 13 MB instead of 105 MB of uint8 bitmaps.
    """
    n = batch_size or len(samples)
    hs = [s["img"].shape[0] for s in samples]
    ws = [s["img"].shape[1] for s in samples]
    th, tw = pad_shape or (max(hs), max(ws))

    img_dtype = samples[0]["img"].dtype if samples else np.float32
    if img_dtype == np.uint8:
        images = np.empty((n, th, tw, 3), np.uint8)
        images[...] = np.round(PAD_VALUE_BGR).astype(np.uint8)
    else:
        images = np.zeros((n, th, tw, 3), np.float32)
    img_shape = np.zeros((n, 2), np.int32)
    gt_bboxes = np.zeros((n, max_gt, 4), np.float32)
    gt_labels = np.zeros((n, max_gt), np.int32)
    gt_valid = np.zeros((n, max_gt), bool)
    gt_masks = np.zeros((n, max_gt, th, tw), np.uint8 if pack_masks else np.float32)
    metas = []
    for i, s in enumerate(samples):
        h, w = s["img"].shape[:2]
        images[i, :h, :w] = s["img"]
        img_shape[i] = s["img_shape"]
        g = min(len(s.get("gt_bboxes", ())), max_gt)
        if g:
            gt_bboxes[i, :g] = s["gt_bboxes"][:g]
            gt_labels[i, :g] = s["gt_labels"][:g]
            gt_valid[i, :g] = ~s["gt_ignore_flags"][:g]
            mh, mw = s["gt_masks"].shape[1:]
            gt_masks[i, :g, :mh, :mw] = s["gt_masks"][:g]
        metas.append(
            dict(
                img_id=s.get("img_id", i),
                img_path=s.get("img_path", ""),
                ori_shape=s["ori_shape"],
                img_shape=tuple(s["img_shape"]),
                scale_factor=tuple(s["scale_factor"]),
                batch_input_shape=(th, tw),
            )
        )
    while len(metas) < n:
        metas.append(dict(metas[-1], img_id=-1))
    batch = dict(
        images=images,
        img_shape=img_shape,
        gt_bboxes=gt_bboxes,
        gt_labels=gt_labels,
        gt_valid=gt_valid,
    )
    if pack_masks:
        batch["gt_masks_packed"] = np.packbits(gt_masks, axis=-1)
    else:
        batch["gt_masks"] = gt_masks
    return batch, metas


def build_train_pipeline(crop_size=(1024, 1024), rng=None):
    return [
        RandomFlip(0.5, rng=rng),
        RandomResize(crop_size, (0.1, 2.0), rng=rng),
        RandomCrop(crop_size, rng=rng),
        FilterAnnotations(),
        PackDetInputs(),
    ]


def build_test_pipeline(crop_size=(1024, 1024)):
    return [Resize(crop_size), Pad(crop_size), PackDetInputs()]
