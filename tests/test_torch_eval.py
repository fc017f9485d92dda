"""The port's evaluation chain held against the JAX package's on the CPU.

- ``CocoEvaluator``: every synthetic case of ``tests/test_evaluation.py`` and
  ``tests/test_coco_eval_semantics.py`` (crowd IoF, ignored-GT preference,
  score ties, maxDets truncation, the 101-point boundary, segm areas from
  the RLE, custom IoU ladders, per-class AP) plus seeded multi-image,
  multi-class cases, fed to both packages' evaluators (masks encoded by each
  package's own encoder): ``summarize()`` and ``per_class_ap()`` equal to
  1e-12. The native greedy matcher against its plain loop and JAX's.
- RLE: the port's native library, its numpy plain versions and JAX's
  encoder give identical counts on seeded masks (empty, full, one-pixel,
  odd-sized); decode round-trips; ``iou_matrix`` with crowd flags is equal
  (exactly: integer areas divided once in float64). A source that does not
  compile raises with the compiler's output.
- The slice: ``python -m rsprompter_tpu_torch.tools.test`` on the CPU at
  tiny width (the encoder of ``tests/test_sam_parity.py``'s ``VISION_KW``,
  hidden 32) over five PNG images of about 64 x 80: its printed metrics
  equal, to 1e-9, JAX's ``CocoMetric`` fed the tool's own
  ``(dets, probs_u8, metas)`` and the GT of JAX's ``CocoDataset.load_raw``;
  its ``--out`` file read back through JAX's ``from_jsonable`` and
  ``CocoEvaluator`` gives the same numbers.
"""

import json
import math

import numpy as np
import pytest

from rsprompter_tpu.evaluation import coco_eval as jax_coco_eval
from rsprompter_tpu.evaluation import rle as jax_rle
from rsprompter_tpu.evaluation.coco_metric import CocoMetric as JaxCocoMetric
from rsprompter_tpu.evaluation.coco_metric import from_jsonable as jax_from_jsonable
from rsprompter_tpu.evaluation.coco_metric import gt_from_raw_sample as jax_gt_from_raw_sample
from rsprompter_tpu_torch.evaluation import coco_eval, rle
from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric, gt_from_raw_sample

EVAL_TOL = 1e-12  # summarize() / per_class_ap() of the two evaluators
TOOL_TOL = 1e-9  # the tool's printed metrics against JAX's CocoMetric


# --- evaluator cases: (evaluator kwargs, [(dets, gts), ...]); masks binary --


def _dets(rows, label=0):
    rows = np.asarray(rows, np.float64).reshape(-1, 5)
    return dict(bboxes=rows[:, 1:], scores=rows[:, 0],
                labels=np.full(len(rows), label, np.int64))


def _gts(rows, iscrowd=None, areas=None):
    rows = np.asarray(rows, np.float64).reshape(-1, 4)
    g = dict(bboxes=rows, labels=np.zeros(len(rows), np.int64))
    if iscrowd is not None:
        g["iscrowd"] = np.asarray(iscrowd, bool)
    if areas is not None:
        g["areas"] = np.asarray(areas, np.float64)
    return g


def _rand_masks(rs, n, h, w):
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        y, x = rs.randint(0, h - 5), rs.randint(0, w - 5)
        masks[i, y:y + rs.randint(2, 6), x:x + rs.randint(2, 6)] = 1
    return masks


def _perfect(n=5):
    rs = np.random.RandomState(2)
    boxes = []
    for _ in range(n):
        x, y = rs.rand(2) * 50
        w, h = rs.rand(2) * 30 + 40
        boxes.append([x, y, x + w, y + h])
    boxes = np.array(boxes)
    gts = dict(bboxes=boxes, labels=np.zeros(n, np.int64), iscrowd=np.zeros(n, bool),
               areas=(boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    dets = dict(bboxes=boxes.copy(), scores=np.linspace(0.9, 0.5, n),
                labels=np.zeros(n, np.int64))
    return dets, gts


def case_perfect():
    return {}, [_perfect()]


def case_false_positive():
    dets, gts = _perfect()
    dets["bboxes"] = np.vstack([[500, 500, 540, 540], dets["bboxes"]])
    dets["scores"] = np.concatenate([[0.99], dets["scores"]])
    dets["labels"] = np.concatenate([[0], dets["labels"]])
    return {}, [(dets, gts)]


def case_missed_gt():
    dets, gts = _perfect(4)
    return {}, [({k: v[:2] for k, v in dets.items()}, gts)]


def case_localization():
    return {}, [(
        dict(bboxes=np.array([[0.0, 25.0, 100.0, 125.0]]), scores=np.array([0.9]),
             labels=np.array([0])),
        dict(bboxes=np.array([[0.0, 0.0, 100.0, 100.0]]), labels=np.array([0]),
             iscrowd=np.array([False]), areas=np.array([10000.0])),
    )]


def case_segm():
    masks = _rand_masks(np.random.RandomState(3), 3, 64, 64)
    boxes = np.array([[0, 0, 10, 10]] * 3, np.float64)
    return dict(iou_type="segm"), [(
        dict(bboxes=boxes, scores=np.array([0.9, 0.8, 0.7]), labels=np.zeros(3, np.int64),
             masks=masks),
        dict(bboxes=boxes, labels=np.zeros(3, np.int64), iscrowd=np.zeros(3, bool),
             areas=masks.reshape(3, -1).sum(1).astype(np.float64), masks=masks),
    )]


def _one_box(thrs):
    boxes = np.array([[0, 0, 10, 10]], np.float64)
    return dict(iou_thrs=thrs), [(
        dict(bboxes=boxes, scores=np.array([0.9]), labels=np.zeros(1, np.int64)),
        dict(bboxes=boxes, labels=np.zeros(1, np.int64), iscrowd=np.zeros(1, bool),
             areas=np.array([100.0])),
    )]


def case_ladder_01():
    return _one_box([0.1])


def case_ladder_50_75():
    return _one_box([0.5, 0.75])


def case_crowd_iof():
    return {}, [(_dets([(0.9, 0, 0, 10, 10), (0.8, 22, 22, 30, 30)]),
                 _gts([(0, 0, 10, 10), (20, 20, 40, 40)], iscrowd=[False, True]))]


def case_crowd_rematch():
    return {}, [(_dets([(0.9, 20, 20, 30, 30), (0.8, 30, 30, 40, 40), (0.7, 0, 0, 10, 10)]),
                 _gts([(0, 0, 10, 10), (20, 20, 40, 40)], iscrowd=[False, True]))]


def case_ignored_gt_preferred():
    return {}, [(_dets([(0.9, 100, 100, 150, 150), (0.8, 0, 0, 50, 50)]),
                 _gts([(0, 0, 50, 50), (100, 100, 150, 150)], areas=[10.0, 2500.0]))]


def case_nonignored_beats_ignored():
    return {}, [(_dets([(0.9, 0, 0, 11, 11)]),
                 _gts([(0, 0, 10, 10), (0, 0, 12, 12)], iscrowd=[False, True]))]


def case_score_tie():
    return {}, [(_dets([(0.5, 50, 50, 60, 60), (0.5, 0, 0, 10, 10)]),
                 _gts([(0, 0, 10, 10), (20, 20, 30, 30)]))]


def case_segm_area_from_rle():
    gt_mask = np.zeros((100, 100), np.uint8)
    gt_mask[0:10, 0:10] = 1
    det_fp = np.zeros((100, 100), np.uint8)
    det_fp[50:60, 50:75] = 1
    det_fp[80:90, 10:35] = 1
    return dict(iou_type="segm"), [(
        dict(bboxes=np.array([[0, 0, 10, 10], [10, 50, 75, 90]], np.float64),
             scores=np.array([0.9, 0.95]), labels=np.zeros(2, np.int64),
             masks=np.stack([gt_mask, det_fp])),
        dict(bboxes=np.array([[0, 0, 10, 10]], np.float64), labels=np.zeros(1, np.int64),
             areas=np.array([100.0]), masks=gt_mask[None]),
    )]


def case_maxdets():
    return dict(max_dets=1), [(_dets([(0.9, 50, 50, 60, 60), (0.5, 0, 0, 10, 10)]),
                               _gts([(0, 0, 10, 10)]))]


def case_101_point():
    return {}, [(_dets([(0.9, 0, 0, 10, 10)]), _gts([(0, 0, 10, 10), (20, 20, 30, 30)]))]


def case_gt_area_from_annotation():
    raw = dict(gt_bboxes=np.array([[0, 0, 80, 80]], np.float32),
               gt_labels=np.zeros(1, np.int64), gt_ignore_flags=np.zeros(1, bool),
               gt_areas=np.array([400.0]), gt_masks=np.zeros((1, 100, 100), np.uint8))
    return {}, [(_dets([(0.9, 0, 0, 80, 80)]), ("raw", raw))]


def _random_images(seed, iou_type, n_img=4, classes=3, h=48, w=56):
    """Seeded images of several classes: GT boxes with masks inside them,
    some crowd; detections that jitter, drop and duplicate them, plus false
    positives, with tied scores."""
    rs = np.random.RandomState(seed)
    images = []
    for _ in range(n_img):
        g = rs.randint(0, 7)
        gb, gm = [], []
        for _ in range(g):
            x0, y0 = rs.randint(0, w - 8), rs.randint(0, h - 8)
            x1, y1 = x0 + rs.randint(3, w - x0), y0 + rs.randint(3, h - y0)
            m = np.zeros((h, w), np.uint8)
            m[y0:y1, x0:x1] = rs.rand(y1 - y0, x1 - x0) < 0.8
            gb.append([x0, y0, x1, y1])
            gm.append(m)
        gb = np.asarray(gb, np.float64).reshape(-1, 4)
        gm = np.stack(gm) if gm else np.zeros((0, h, w), np.uint8)
        gl = rs.randint(0, classes, g).astype(np.int64)
        gts = dict(bboxes=gb, labels=gl, iscrowd=rs.rand(g) < 0.15,
                   areas=gm.sum(axis=(1, 2)).astype(np.float64), masks=gm)
        keep = [i for i in range(g) if rs.rand() < 0.8] + [i for i in range(g) if rs.rand() < 0.2]
        db = gb[keep] + rs.randn(len(keep), 4) * 2
        dm = [np.roll(gm[i], rs.randint(-2, 3), axis=rs.randint(0, 2)) for i in keep]
        dl = gl[keep].copy()
        for _ in range(rs.randint(0, 4)):  # false positives
            x0, y0 = rs.randint(0, w - 6), rs.randint(0, h - 6)
            db = np.vstack([db, [x0, y0, x0 + 5, y0 + 5]])
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + 5, x0:x0 + 5] = 1
            dm.append(m)
            dl = np.append(dl, rs.randint(0, classes))
        scores = np.round(rs.rand(len(db)), 1)  # ties
        dets = dict(bboxes=db, scores=scores, labels=dl.astype(np.int64),
                    masks=np.stack(dm) if dm else np.zeros((0, h, w), np.uint8))
        if iou_type == "bbox":
            dets.pop("masks")
        images.append((dets, gts))
    return dict(num_classes=classes, iou_type=iou_type), images


CASES = {
    "perfect": case_perfect,
    "false_positive": case_false_positive,
    "missed_gt": case_missed_gt,
    "localization": case_localization,
    "segm": case_segm,
    "ladder_0.1": case_ladder_01,
    "ladder_0.5_0.75": case_ladder_50_75,
    "crowd_iof": case_crowd_iof,
    "crowd_rematch": case_crowd_rematch,
    "ignored_gt_preferred": case_ignored_gt_preferred,
    "nonignored_beats_ignored": case_nonignored_beats_ignored,
    "score_tie": case_score_tie,
    "segm_area_from_rle": case_segm_area_from_rle,
    "maxdets": case_maxdets,
    "101_point": case_101_point,
    "gt_area_from_annotation": case_gt_area_from_annotation,
    "random_bbox": lambda: _random_images(0, "bbox"),
    "random_segm": lambda: _random_images(1, "segm"),
    "random_segm_maxdets": lambda: (lambda kw, im: (dict(kw, max_dets=3), im))(
        *_random_images(2, "segm")),
    "random_bbox_ladder": lambda: (lambda kw, im: (dict(kw, iou_thrs=[0.3, 0.5, 0.75]), im))(
        *_random_images(3, "bbox")),
}


def _run(evaluator_cls, encode, gt_from_raw, kwargs, images):
    kw = dict(kwargs)
    ev = evaluator_cls(kw.pop("num_classes", 1), **kw)
    for dets, gts in images:
        if isinstance(gts, tuple):  # a raw sample through the package's gt_from_raw_sample
            gts = gt_from_raw(gts[1])
        dets, gts = dict(dets), dict(gts)
        for d in (dets, gts):
            if "masks" in d and not isinstance(d["masks"], list):
                d["masks"] = encode(np.asarray(d["masks"]))
        ev.add_image(dets, gts)
    return ev.summarize(), ev.per_class_ap()


def _assert_close(got, ref, tol):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_close(got[k], ref[k], tol)
        elif math.isnan(ref[k]):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_jax(case):
    kwargs, images = CASES[case]()
    ref = _run(jax_coco_eval.CocoEvaluator, jax_rle.encode_masks, jax_gt_from_raw_sample,
               kwargs, images)
    got = _run(coco_eval.CocoEvaluator, rle.encode_masks, gt_from_raw_sample, kwargs, images)
    _assert_close(got[0], ref[0], EVAL_TOL)
    _assert_close(got[1], ref[1], EVAL_TOL)
    assert any(not math.isnan(v) for v in got[0].values())


def test_native_matcher_matches_plain_and_jax():
    """The native greedy match against its plain loop and JAX's
    ``_match_image``, on random IoU matrices with crowd and ignore flags."""
    rs = np.random.RandomState(0)
    for case in range(20):
        d, g = rs.randint(1, 12), rs.randint(1, 8)
        ious = rs.rand(d, g)
        gt_ignore = np.sort(rs.rand(g) < 0.3)
        gt_crowd = gt_ignore & (rs.rand(g) < 0.5)
        thrs = coco_eval.IOU_THRS
        native = coco_eval.match_greedy(ious, gt_ignore, gt_crowd, thrs)
        plain = coco_eval.match_greedy_plain(ious, gt_ignore, gt_crowd, thrs)
        for a, b in zip(native, plain):
            np.testing.assert_array_equal(a, b, err_msg=f"case {case}")
        det_areas = rs.rand(d) * 5000
        got = coco_eval._match_image(ious, gt_ignore, gt_crowd, det_areas, (100.0, 4000.0))
        ref = jax_coco_eval._match_image(ious, gt_ignore, gt_crowd, det_areas, (100.0, 4000.0))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"case {case}")


# --- RLE ------------------------------------------------------------------


def _seeded_masks():
    rs = np.random.RandomState(7)
    out = {
        "empty": np.zeros((2, 9, 11), np.uint8),
        "full": np.ones((2, 9, 11), np.uint8),
        "one_pixel_on": np.ones((1, 1, 1), np.uint8),
        "one_pixel_off": np.zeros((1, 1, 1), np.uint8),
        "odd": (rs.rand(5, 7, 13) < 0.5).astype(np.uint8),
        "blobs": _rand_masks(rs, 6, 33, 41),
        "bool": rs.rand(3, 17, 5) < 0.3,
    }
    edges = np.zeros((4, 6, 8), np.uint8)
    edges[0, 0, 0] = edges[1, -1, -1] = 1  # first and last pixel
    edges[2, :, 0] = edges[3, 0, :] = 1
    out["corners"] = edges
    return out


@pytest.mark.parametrize("name", sorted(_seeded_masks()))
def test_rle_matches_plain_and_jax(name):
    masks = _seeded_masks()[name]
    native = rle.encode_masks(masks)
    plain = rle.encode_masks_plain(masks)
    ref = jax_rle.encode_masks(masks)
    assert len(native) == len(plain) == len(ref) == len(masks)
    for a, b, c, m in zip(native, plain, ref, masks):
        assert (a.h, a.w) == (b.h, b.w) == (c.h, c.w) == m.shape
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.counts, c.counts)
        assert a.area() == int(np.count_nonzero(m))
        np.testing.assert_array_equal(rle.decode_mask(a), m.astype(np.uint8))
        np.testing.assert_array_equal(rle.decode_mask_plain(a), m.astype(np.uint8))
    crowd = np.arange(len(masks)) % 2 == 1
    for flags in (None, crowd):
        got = rle.iou_matrix(native, native[::-1], flags)
        np.testing.assert_array_equal(got, rle.iou_matrix_plain(native, native[::-1], flags))
        np.testing.assert_array_equal(got, jax_rle.iou_matrix(ref, ref[::-1], flags))


def test_rle_iou_crowd_and_empty():
    dets = np.zeros((2, 10, 10), np.uint8)
    dets[0, :5, :5] = 1
    gts = np.ones((1, 10, 10), np.uint8)
    d, g = rle.encode_masks(dets), rle.encode_masks(gts)
    np.testing.assert_array_equal(rle.iou_matrix(d, g, [True]), [[1.0], [0.0]])
    np.testing.assert_array_equal(rle.iou_matrix(d, g, [False]), [[0.25], [0.0]])
    assert rle.iou_matrix([], g).shape == (0, 1) and rle.encode_masks(dets[:0]) == []


def test_rle_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "rle.cpp"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(rle, "SOURCE", bad)
    monkeypatch.setattr(rle, "BUILD_DIR", tmp_path / "build")
    assert rle.library_path().parent == tmp_path / "build"
    with pytest.raises(RuntimeError, match="building rle.cpp failed") as err:
        rle.build_library()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("n", [1, 5, 9])
def test_finalize_masks_np_matches_jax(n):
    """The port's chunked, in-place mask finalisation gives JAX's bits: u8
    and float probabilities, stacks that are not a multiple of the chunk,
    thresholded and not."""
    from rsprompter_tpu.ops.masks import finalize_masks_np as jax_finalize
    from rsprompter_tpu_torch.ops.masks import finalize_masks_np

    rng = np.random.default_rng(n)
    u8 = rng.integers(0, 256, (n, 32, 32), dtype=np.uint8)
    for probs in (u8, u8.astype(np.float32) / 255 + 1e-3):
        for thr in (0.5, -1):
            args = (probs, (96, 96), (70, 45), (0.6857, 1.3714))
            np.testing.assert_array_equal(finalize_masks_np(*args, thr=thr),
                                          jax_finalize(*args, thr=thr))


def test_paste_mode_names_its_slice(tmp_path):
    """``mask_mode='paste'`` (SAM-seg Mask R-CNN's RoI maps) pastes each map
    into its box at the original size, where the full-frame chain would
    stretch it over the whole image; other modes raise."""
    import json

    from rsprompter_tpu_torch.evaluation.rle import RLE, decode_mask
    from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult

    dump = tmp_path / "dump.json"
    metric = CocoMetric(num_classes=1, mask_mode="paste", dump_path=str(dump))
    sf = 64 / 60
    meta = dict(img_id=0, ori_shape=(40, 60), batch_input_shape=(64, 64), scale_factor=(sf, sf))
    box = np.array([[[8.0, 4.0, 24.0, 20.0]]], np.float32) * sf  # in the batch input
    dets = DetResult(box, np.ones((1, 1), np.float32), np.zeros((1, 1), np.int64),
                     np.ones((1, 1), bool))
    metric.process([meta], dets, np.full((1, 1, 28, 28), 255, np.uint8))
    metric.compute()
    rle = json.loads(dump.read_text())["images"][0]["det"]["masks"][0]
    ys, xs = np.nonzero(decode_mask(RLE.from_coco(rle)))
    assert (xs.min(), ys.min(), xs.max(), ys.max()) == (8, 4, 23, 19)
    with pytest.raises(ValueError, match="fullframe"):
        CocoMetric(num_classes=1, mask_mode="roi")


# --- the slice: the test tool on the CPU ----------------------------------

CLASSES = ("airplane", "ship", "storage_tank", "baseball_diamond", "tennis_court",
           "basketball_court", "ground_track_field", "harbor", "bridge", "vehicle")
TINY_MODEL = dict(
    type="RSPrompterAnchor", bf16=False, num_classes=len(CLASSES), prompt_shape=(10, 3),
    image_size=64, select_layers=(1, 2), aggregator_hidden=8,
    vision_config=dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                       global_attn_indexes=(1,), image_size=64, patch_size=8, window_size=4,
                       output_channels=32),
    rpn_strides=(2, 4, 8, 16, 32), roi_strides=(2, 4, 8, 16),
    test_cfg=dict(rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
                  rcnn=dict(score_thr=0.0, nms_iou_thr=0.5, max_per_img=8, nms_pre=40)),
)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """Five seeded PNG images (cv2 writes them) with polygon, RLE and crowd
    GT, one image without any."""
    import cv2

    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

    return synthetic_coco(str(tmp_path_factory.mktemp("coco")), CLASSES,
                          ((64, 80), (70, 64), (64, 64), (60, 90), (72, 66)), cv2.imwrite)


def _write_config(tmp_path, coco_dir, batch_size=2):
    ds = dict(type="NWPUInsSegDataset", data_root=str(coco_dir), ann_file="ann.json",
              data_prefix=dict(img="imgs"), test_mode=True)
    path = tmp_path / "tiny_eval.py"
    path.write_text(
        f"model = {TINY_MODEL!r}\ncrop_size = (64, 64)\n"
        f"val_dataloader = dict(batch_size={batch_size}, dataset={ds!r})\n"
        "test_dataloader = val_dataloader\n")
    return path


def _plant_gt(dets, probs, metas, dataset, by_id):
    """Random weights match no GT, which would make every AP 0. Overwrite
    the first detections of each image with its GT (box and label, a mask
    nearest-resized into the decoder's frame, scores from a seed), so the
    AP the chain computes lies strictly between 0 and 1."""
    import torch

    dets = type(dets)(*[t.clone() for t in dets])
    probs = probs.clone()
    rng = np.random.default_rng(0)
    s = probs.shape[-1]
    for i, meta in enumerate(metas):
        if meta["img_id"] == -1:
            continue
        raw = dataset.load_raw(by_id[meta["img_id"]])
        sw, sh = meta["scale_factor"]
        th, tw = meta["batch_input_shape"]
        for j, (box, label, mask) in enumerate(zip(raw["gt_bboxes"], raw["gt_labels"],
                                                   raw["gt_masks"])):
            if j % 3 == 2:  # leave some GT unfound
                continue
            dets.boxes[i, j] = torch.as_tensor(box * np.array([sw, sh, sw, sh]))
            dets.labels[i, j] = int(label)
            dets.scores[i, j] = float(rng.uniform(0.2, 1.0))
            dets.valid[i, j] = True
            # the mask in the padded input frame, then at the decoder's size
            ys = np.clip((np.arange(s) + 0.5) * th / s / sh, 0, mask.shape[0] - 1).astype(int)
            xs = np.clip((np.arange(s) + 0.5) * tw / s / sw, 0, mask.shape[1] - 1).astype(int)
            probs[i, j] = torch.as_tensor(mask[ys[:, None], xs[None, :]] * 255)
    return dets, probs


def test_tool_matches_jax_metric(coco_dir, tmp_path, capsys, monkeypatch):
    """The tool's printed metrics equal JAX's CocoMetric on the tool's own
    predictions and JAX's GT; its --out file re-evaluates to the same."""
    from rsprompter_tpu.data.coco import NWPUInsSegDataset as JaxNWPU
    from rsprompter_tpu_torch.apis.inference import DetInferencer
    from rsprompter_tpu_torch.data.coco import NWPUInsSegDataset
    from rsprompter_tpu_torch.tools import test as tool

    seen = []  # (dets, probs_u8, metas) of every batch, as the tool made them
    predict_batch = DetInferencer.predict_batch
    port_ds = NWPUInsSegDataset(ann_file="ann.json", data_root=str(coco_dir),
                                data_prefix=dict(img="imgs"), test_mode=True)
    by_id = {d["img_id"]: i for i, d in enumerate(port_ds.data_list)}

    def spy(self, imgs, metas=None):
        dets, probs, metas = predict_batch(self, imgs, metas)
        dets, probs = _plant_gt(dets, probs, metas, port_ds, by_id)
        seen.append((tool._to_host(dets), probs.cpu().numpy(), metas))
        return dets, probs, metas

    monkeypatch.setattr(DetInferencer, "predict_batch", spy)
    cfg = _write_config(tmp_path, coco_dir)
    out_path = tmp_path / "dump.json"
    report = tool.main([str(cfg), "--device", "cpu", "--classwise", "--out", str(out_path)])
    printed = {}
    for line in capsys.readouterr().out.splitlines():
        k, sep, v = line.partition(": ")
        if sep and k.startswith("coco/"):
            printed[k] = float(v)
    assert printed.keys() == report["metrics"].keys()
    assert len(seen) == 3 and [m["img_id"] for m in seen[-1][2]] == [5, -1]
    assert report["timing"]["images"] == 5

    jax_ds = JaxNWPU(ann_file="ann.json", data_root=str(coco_dir),
                     data_prefix=dict(img="imgs"), test_mode=True)
    id_to_idx = {d["img_id"]: i for i, d in enumerate(jax_ds.data_list)}
    ref_metric = JaxCocoMetric(num_classes=len(CLASSES), classwise=True, class_names=CLASSES)
    for dets, probs, metas in seen:
        gts = [jax_gt_from_raw_sample(jax_ds.load_raw(id_to_idx[m["img_id"]]))
               if m["img_id"] != -1 else None for m in metas]
        ref_metric.process(metas, dets, probs, gts)
    ref = ref_metric.compute()
    assert printed.keys() == ref.keys()
    assert "coco/bbox_mAP" in ref and "coco/segm_mAP_l" in ref
    for k in ref:
        if math.isnan(ref[k]):
            assert math.isnan(printed[k]), k
        else:
            assert abs(printed[k] - ref[k]) <= TOOL_TOL, (k, printed[k], ref[k])
    assert 0 < printed["coco/bbox_mAP"] < 1 and 0 < printed["coco/segm_mAP"] < 1

    dump = json.loads(out_path.read_text())
    assert dump["num_classes"] == len(CLASSES) and len(dump["images"]) == 5
    evs = {m: jax_coco_eval.CocoEvaluator(dump["num_classes"], iou_type=m)
           for m in dump["metrics"]}
    for rec in dump["images"]:
        for ev in evs.values():
            ev.add_image(jax_from_jsonable(rec["det"]), jax_from_jsonable(rec["gt"]))
    for m, ev in evs.items():
        for k, v in ev.summarize().items():
            want = report["metrics"][f"coco/{k}"]
            assert (math.isnan(v) and math.isnan(want)) or abs(v - want) <= TOOL_TOL, k


def test_tool_refuses_untaken_flags(tmp_path):
    """``--tta``, ``--show-dir`` and ``--corruption`` are taken; the weather
    corruptions (no texture files), a severity out of 1..5 and ``--tta``
    beside ``--oracle`` are refused, as JAX's tool refuses them."""
    from rsprompter_tpu_torch.tools import test as tool

    args = tool.parse_args(["cfg.py", "--tta", "--show-dir", "x", "--corruption",
                            "motion_blur", "--severity", "5"])
    assert args.tta and args.show_dir == "x" and (args.corruption, args.severity) == (
        "motion_blur", 5)
    for flag in (["--corruption", "fog"], ["--corruption", "pixelate", "--severity", "6"],
                 ["--tta", "--oracle"]):
        with pytest.raises(SystemExit):
            tool.parse_args(["cfg.py"] + flag)
