"""The port's ``utils/large_image.py`` against the JAX package's on seeded
inputs, exactly: tile offsets over scene and patch sizes, greedy NMS,
the shift-and-merge of per-patch predictions (with masks, without, and
with only some patches carrying them), and the scene masks pasted from
the merge's (patch mask, offset) pairs."""

import numpy as np
import pytest

from rsprompter_tpu.utils import large_image as jax_li
from rsprompter_tpu_torch.utils import large_image as li


@pytest.mark.parametrize("h,w,patch,overlap", [
    (2600, 3400, 1024, 0.25), (1024, 1024, 1024, 0.25), (500, 700, 1024, 0.0),
    (1500, 900, 512, 0.5), (1, 1, 8, 0.9), (2049, 4097, 1024, 0.0)])
def test_slice_offsets(h, w, patch, overlap):
    assert li.slice_offsets(h, w, patch, overlap) == jax_li.slice_offsets(h, w, patch, overlap)


def test_slice_offsets_refuses_bad_overlap():
    with pytest.raises(ValueError, match="overlap"):
        li.slice_offsets(100, 100, 64, 1.0)


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,thr", [(0, 0.5), (1, 0.5), (40, 0.5), (40, 0.2), (200, 0.7)])
def test_nms(n, thr):
    rng = np.random.default_rng(n)
    boxes, scores = _boxes(rng, n), rng.uniform(0, 1, n).astype(np.float32)
    scores[: n // 4] = 0.5  # ties
    np.testing.assert_array_equal(li.nms_np(boxes, scores, thr),
                                  jax_li.nms_np(boxes, scores, thr))


def _preds(rng, n_patches, patch, masks):
    preds = []
    for p in range(n_patches):
        n = int(rng.integers(0, 12))
        pred = dict(bboxes=_boxes(rng, n, patch), scores=rng.uniform(0, 1, n).astype(np.float32),
                    labels=rng.integers(0, 3, n))
        if masks == "all" or (masks == "some" and p % 2):
            pred["masks"] = rng.uniform(0, 1, (n, patch, patch)) > 0.7
        preds.append(pred)
    return preds


@pytest.mark.parametrize("masks", ["all", "some", "none"])
def test_merge_and_paste(masks):
    rng = np.random.default_rng(["all", "some", "none"].index(masks))
    h, w, patch = 150, 230, 64
    offsets = li.slice_offsets(h, w, patch, 0.25)
    preds = _preds(rng, len(offsets), patch, masks)
    got = li.merge_patch_predictions(preds, offsets, (h, w), iou_thr=0.5, max_dets=40)
    ref = jax_li.merge_patch_predictions(preds, offsets, (h, w), iou_thr=0.5, max_dets=40)
    for k in ("bboxes", "scores", "labels"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert (got["masks"] is None) == (ref["masks"] is None) == (masks == "none")
    if masks != "none":
        for a, b in zip(li.paste_scene_masks(got["masks"], (h, w)),
                        jax_li.paste_scene_masks(ref["masks"], (h, w))):
            np.testing.assert_array_equal(a, b)


def test_merge_of_nothing():
    got = li.merge_patch_predictions([dict(bboxes=np.zeros((0, 4)), scores=np.zeros(0),
                                           labels=np.zeros(0, np.int64))], [(0, 0)], (10, 10))
    ref = jax_li.merge_patch_predictions([dict(bboxes=np.zeros((0, 4)), scores=np.zeros(0),
                                               labels=np.zeros(0, np.int64))], [(0, 0)], (10, 10))
    assert got["masks"] is None and ref["masks"] is None
    np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
