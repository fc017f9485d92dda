"""``DetInferencer`` on image paths, size buckets and drawn output, against
the JAX package's ``apis/inferencer.py`` on the CPU at tiny width.

- ``_bucket_for`` gives JAX's bucket on a grid of sizes and bucket lists;
  a chunk of mixed sizes runs at one bucket, the smallest that fits all.
- ``make_batch``'s uint8 images at a bucket equal JAX's ``make_infer_batch``
  (numpy pipeline: OpenCV's resize, the mean pad, the uint8 round) within
  the port's resize bound (``tests/test_torch_resize.py``: at most 1e-3 of
  the pixels one level apart, OpenCV's vector code ordering its float sums
  differently), with the same metas.
- A JPEG path (the port's decoder), a PNG path and the array give the same
  predictions.
- ``out_dir``: one drawing an input under JAX's names (the path's basename,
  ``img_{n}.jpg`` for an array) at the input's shape, a ``.jpg`` one the
  bytes ``cv2.imencode`` gives the drawing at quality 95, and
  ``predictions.json`` with JAX's keys, no masks.
- ``verify_weights`` raises on a garbage SAM file or weights file; JAX's
  ``mask_transfer`` and ``exported`` are not parameters of the port's.
- ``draw_predictions``: boxes and the mask blend equal JAX's (OpenCV's
  rectangle, JAX's blend formula) on every pixel outside the labels' text.
"""

import json
import os
import pickle
import types

import cv2
import numpy as np
import pytest

from rsprompter_tpu.apis.inferencer import DetInferencer as JaxInferencer
from rsprompter_tpu.apis.inferencer import draw_predictions as jax_draw
from rsprompter_tpu.apis.inferencer import make_infer_batch
from rsprompter_tpu_torch.apis.inference import DetInferencer
from rsprompter_tpu_torch.apis.visualization import draw_predictions
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.data.io import decode_png, imread
from test_torch_eval import TINY_MODEL

CROP = (64, 64)


@pytest.fixture(scope="module")
def inferencer():
    cfg = Config.fromdict(dict(model=TINY_MODEL, crop_size=CROP))
    return DetInferencer(cfg, device="cpu", batch_size=2, size_buckets=[64, 32, 128])


def _image(rng, h, w):
    coarse = rng.uniform(0, 255, (h // 6 + 1, w // 6 + 1, 3))
    field = np.kron(coarse, np.ones((6, 6, 1)))[:h, :w]
    return np.clip(field + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("buckets", [None, [512, 1024], [1024, 256, 512, 2048], [64]])
def test_bucket_for_matches_jax(buckets):
    sides = (1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1000, 1024, 1025, 2048, 4000)
    ours = types.SimpleNamespace(size_buckets=sorted(buckets) if buckets else None,
                                 crop_size=(1024, 1024))
    for h in sides:
        for w in sides:
            assert (DetInferencer._bucket_for(ours, h, w)
                    == JaxInferencer._bucket_for(ours, h, w)), (buckets, h, w)


def test_mixed_chunk_takes_one_bucket(inferencer, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = [_image(rng, 20, 30), _image(rng, 100, 60), _image(rng, 30, 25), _image(rng, 50, 40)]
    crops = []
    make_batch = DetInferencer.make_batch

    def spy(self, imgs, metas=None, gts=None, crop=None):
        crops.append(crop)
        return make_batch(self, imgs, metas, gts, crop)

    monkeypatch.setattr(DetInferencer, "make_batch", spy)
    out = inferencer(imgs)["predictions"]
    assert crops == [(128, 128), (64, 64)]  # chunk 1: 20x30 with 100x60; chunk 2: max 50
    assert len(out) == 4 and all(p["masks"].shape[1:] == im.shape[:2]
                                 for p, im in zip(out, imgs))


@pytest.mark.parametrize("crop", [(32, 32), (64, 64), (128, 128)])
def test_make_batch_matches_jax(inferencer, crop):
    rng = np.random.default_rng(crop[0])
    imgs = [_image(rng, 50, 70), _image(rng, 90, 33)]
    batch, metas = inferencer.make_batch(imgs, crop=crop)
    ref, ref_metas = make_infer_batch([im.astype(np.float32) for im in imgs], crop, 2)
    diff = np.abs(batch["images"].numpy().astype(int) - ref["images"].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(batch["img_shape"].numpy(), ref["img_shape"])
    for m, r in zip(metas, ref_metas):
        for k in ("ori_shape", "img_shape", "scale_factor", "batch_input_shape"):
            assert tuple(m[k]) == tuple(r[k]), k


def _assert_same_predictions(a, b):
    for pa, pb in zip(a, b):
        for k in ("bboxes", "scores", "labels", "masks"):
            np.testing.assert_array_equal(pa[k], pb[k])


def test_paths_and_arrays_and_out_dir(inferencer, tmp_path):
    rng = np.random.default_rng(1)
    img = _image(rng, 45, 60)
    jpg = tmp_path / "scene.jpg"
    cv2.imwrite(str(jpg), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    decoded = cv2.imread(str(jpg), cv2.IMREAD_COLOR)
    png = tmp_path / "scene_png.png"
    cv2.imwrite(str(png), decoded)
    by_array = inferencer([decoded])["predictions"]
    by_jpeg = inferencer(str(jpg))["predictions"]
    out_dir = tmp_path / "out"
    mixed = inferencer([str(png), decoded, str(jpg)], out_dir=str(out_dir))["predictions"]
    _assert_same_predictions(by_jpeg, by_array)
    _assert_same_predictions(mixed, by_array * 3)
    assert sorted(os.listdir(out_dir)) == ["img_1.jpg", "predictions.json", "scene.jpg",
                                           "scene_png.png"]
    for name in ("img_1.jpg", "scene.jpg", "scene_png.png"):
        assert imread(str(out_dir / name)).shape == img.shape
    assert decode_png((out_dir / "scene_png.png").read_bytes()).shape == img.shape
    for name, pred in (("scene.jpg", mixed[2]), ("img_1.jpg", mixed[1])):
        want = cv2.imencode(".jpg", draw_predictions(decoded, pred),
                            [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
        assert (out_dir / name).read_bytes() == want, name
    dumped = json.loads((out_dir / "predictions.json").read_text())
    assert len(dumped) == 3
    for entry, pred in zip(dumped, mixed):
        assert set(entry) == {"bboxes", "scores", "labels"}  # JAX's keys: the masks dropped
        np.testing.assert_allclose(entry["bboxes"], pred["bboxes"], rtol=1e-6)
        assert entry["labels"] == pred["labels"].tolist()


def test_verify_weights_and_refusals(inferencer, tmp_path):
    inferencer.verify_weights()  # no SAM file, seeded weights: nothing to read
    garbage = tmp_path / "garbage.pth"
    garbage.write_bytes(b"not a checkpoint at all")
    model_cfg = inferencer.cfg["model"]
    model_cfg["hf_sam_pretrain_ckpt_path"] = str(garbage)
    try:
        with pytest.raises(pickle.UnpicklingError):
            inferencer.verify_weights()
    finally:
        model_cfg.pop("hf_sam_pretrain_ckpt_path")
    inferencer.weights = str(garbage)
    try:
        with pytest.raises(pickle.UnpicklingError):
            inferencer.verify_weights()
    finally:
        inferencer.weights = None
    cfg = Config.fromdict(dict(model=TINY_MODEL, crop_size=CROP))
    with pytest.raises(TypeError, match="mask_transfer"):
        DetInferencer(cfg, device="cpu", mask_transfer="bits")
    with pytest.raises(TypeError, match="exported"):
        DetInferencer(cfg, device="cpu", exported="model.stablehlo")


def test_draw_matches_jax_outside_the_text():
    rng = np.random.default_rng(2)
    h, w = 120, 160
    img = _image(rng, h, w)
    n = 6
    xy = rng.uniform(-10, 140, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1).astype(np.float32)
    masks = rng.uniform(0, 1, (n, h, w)) > 0.6
    pred = dict(bboxes=boxes, scores=rng.uniform(0, 1, n).astype(np.float32),
                labels=rng.integers(0, 12, n), masks=masks)
    got = draw_predictions(img, pred)
    ref = jax_draw(img.astype(np.float32), pred)
    text = np.zeros((h, w), bool)  # where either package may draw a label
    for box, score, label in zip(boxes, pred["scores"], pred["labels"]):
        s = f"{int(label)}:{score:.2f}"
        (tw, th), base = cv2.getTextSize(s, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        x, y = int(box[0]), max(int(box[1]) - 4, 10)
        right = max(x + tw, x + 6 * len(s)) + 2
        text[max(y - max(th, 7) - 2, 0):max(y + base + 2, 0), max(x - 2, 0):max(right, 0)] = True
    assert (got != ref).any(axis=2)[~text].sum() == 0
    assert text.mean() < 0.5  # the comparison covers most of the image
    assert (got != img).any(axis=2)[masks.any(0) & ~text].all()  # the blend drew there
