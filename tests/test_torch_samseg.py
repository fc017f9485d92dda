"""SAM-seg Mask R-CNN and SAM-seg Mask2Former predict of the torch port held
against the JAX package, and the RoI paste of the evaluation path.

fp32 on both sides, on the CPU, tolerance ``TOL`` = 2e-4 relative (sums run
in another order); box corners, pixel coordinates up to 128, take 1e-2
absolute besides. JAX variables are drawn from a seed on ``jax.eval_shape``'s
shapes and carried over by ``utils/convert.py`` into
``load_state_dict(strict=True)``, as in ``test_torch_samdet.py``. Checked:
the FCN mask head and ``StandardRoIHead.predict`` (per-class and
class-agnostic masks) on the same features; both detectors' predict end to
end at 128^2 (Mask R-CNN with the multi-layer and the pseudo aggregator);
``paste_masks_np`` bit for bit against JAX's on ragged boxes partly outside
the image; the port's ``CocoMetric(mask_mode='paste')`` key for key against
JAX's; that JAX's default metric, which the JAX tools use for Mask R-CNN,
reads the RoI maps as full-frame masks (a fault of the reference package);
every shipped SAM-det / SAM-seg config builds; and the SAM file loads into
each family.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.evaluation.coco_metric import CocoMetric as JaxCocoMetric
from rsprompter_tpu.models.roi_heads.bbox_head import DetResult as JaxDetResult
from rsprompter_tpu.models.roi_heads.mask_head import FCNMaskHead as JaxFCNMaskHead
from rsprompter_tpu.models.roi_heads.mask_head import paste_masks_np as jax_paste_masks_np
from rsprompter_tpu.models.roi_heads.standard_roi_head import (
    StandardRoIHead as JaxStandardRoIHead,
)
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.engine import checkpoint as ck
from rsprompter_tpu_torch.evaluation.coco_metric import CocoMetric
from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
from rsprompter_tpu_torch.models.roi_heads.mask_head import FCNMaskHead, paste_masks_np
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import StandardRoIHead

from test_torch_query import _random_variables
from test_torch_samdet import BOX_ATOL, IMAGE, TEST_CFG, _close, _draw, _images, _port, _t

ROOT = pathlib.Path(__file__).resolve().parent.parent
VISION_KW = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, global_attn_indexes=(1,),
    image_size=IMAGE, patch_size=16, window_size=3, output_channels=32,
)
MASKRCNN_TINY = dict(type="SAMSegMaskRCNN", bf16=False, num_classes=3, image_size=IMAGE,
                     select_layers=(1, 2), aggregator_hidden=8, vision_config=VISION_KW,
                     test_cfg=TEST_CFG)
MASK2FORMER_TINY = dict(type="SAMSegMask2Former", bf16=False, num_classes=3, image_size=IMAGE,
                        select_layers=(1, 2), aggregator_hidden=8, vision_config=VISION_KW,
                        prompt_shape=(6, 5), test_cfg=dict(max_per_image=6))
FEAT_SIZES = (32, 16, 8, 4, 2)  # the simple FPN's levels at 128^2


def _feats(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, s, s, 256)).astype(np.float32) for s in FEAT_SIZES]


def test_fcn_mask_head_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 14, 14, 256)).astype(np.float32)
    jmod = JaxFCNMaskHead(num_classes=3)
    variables = _draw(jmod, x)
    ref = jax.jit(jmod.apply)(variables, x)
    port = _port(FCNMaskHead(3), variables)
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == ref.shape == (5, 28, 28, 3)
    _close(got, ref)
    assert {"convs.3.conv.weight", "upsample.weight", "conv_logits.bias"} <= set(
        port.state_dict())


@pytest.mark.parametrize("agnostic", [False, True], ids=["per_class", "class_agnostic"])
def test_standard_roi_head_predict_matches_jax(agnostic):
    """Bbox decode + NMS over proposals, then the 14^2 mask RoIs of the
    detections, the label's channel (or the only one) and the sigmoid."""
    rng = np.random.default_rng(2)
    feats = _feats(3)
    xy = rng.uniform(0, 100, (2, 30, 2))
    wh = rng.uniform(8, 60, (2, 30, 2))
    props = np.concatenate([xy, np.minimum(xy + wh, IMAGE)], -1).astype(np.float32)
    pvalid = rng.random((2, 30)) < 0.9
    shapes = np.array([[IMAGE, IMAGE], [100, 120]], np.int32)
    cfg = dict(num_classes=3, class_agnostic_mask=agnostic, test_cfg=TEST_CFG["rcnn"])
    jmod = JaxStandardRoIHead(**cfg)
    variables = _draw(jmod, feats, props, pvalid, shapes, method="predict")
    j_dets, j_probs = jax.jit(lambda v, *a: jmod.apply(v, *a, method="predict"))(
        variables, feats, props, pvalid, shapes)
    port = _port(StandardRoIHead(3, class_agnostic_mask=agnostic, test_cfg=TEST_CFG["rcnn"]),
                 variables)
    with torch.no_grad():
        t_dets, t_probs = port.predict([_t(f) for f in feats], _t(props),
                                       torch.from_numpy(pvalid), torch.from_numpy(shapes))
    _compare_dets(t_dets, t_probs, j_dets, j_probs)


def _compare_dets(t_dets, t_probs, j_dets, j_probs):
    valid = np.asarray(j_dets.valid)
    np.testing.assert_array_equal(t_dets.valid.numpy(), valid)
    assert valid.sum() > 2
    np.testing.assert_array_equal(t_dets.labels.numpy()[valid], np.asarray(j_dets.labels)[valid])
    _close(t_dets.scores.numpy()[valid], np.asarray(j_dets.scores)[valid], "scores")
    _close(t_dets.boxes.numpy()[valid], np.asarray(j_dets.boxes)[valid], "boxes", BOX_ATOL)
    assert t_probs.shape == j_probs.shape
    _close(t_probs.numpy()[valid], np.asarray(j_probs)[valid], "mask probs")


def _jax_and_port(model_cfg, seed):
    jmod = jax_build_detector(dict(model_cfg))
    batch = dict(images=_images(seed), img_shape=np.array([[IMAGE, IMAGE], [100, 120]], np.int32))
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    variables = _random_variables(shapes, np.random.default_rng(seed))
    port = _port(build_detector(dict(model_cfg)), variables)
    return jmod, variables, port, batch


@pytest.mark.parametrize("aggregator", ["multi", "pseudo"])
def test_maskrcnn_predict_matches_jax(aggregator):
    """SAM encoder -> aggregator + simple FPN -> RPN -> bbox head -> FCN
    mask head: (B, 8) detections and their 28^2 mask probabilities."""
    cfg = dict(MASKRCNN_TINY, aggregator_type=aggregator)
    jmod, variables, port, batch = _jax_and_port(cfg, 4)
    j_dets, j_probs = jax.jit(lambda v, b: jmod.apply(v, b, method="predict"))(variables, batch)
    t_dets, t_probs = port.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    assert t_probs.shape == (2, 8, 28, 28)
    _compare_dets(t_dets, t_probs, j_dets, j_probs)
    assert port.mask_mode == "paste"


def test_mask2former_predict_matches_jax():
    """SAM encoder -> neck -> the stock Mask2Former head (no SAM decode) ->
    top-k instances: boxes, scores, labels and the 32^2 mask probabilities."""
    jmod, variables, port, batch = _jax_and_port(MASK2FORMER_TINY, 5)
    j_dets, j_probs = jax.jit(lambda v, b: jmod.apply(v, b, method="predict"))(variables, batch)
    t_dets, t_probs = port.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    assert t_probs.shape == (2, 6, 32, 32)
    _compare_dets(t_dets, t_probs, j_dets, j_probs)
    sd = port.state_dict()
    assert "panoptic_head.cls_embed.weight" in sd
    assert not any(k.startswith(("shared_image_embedding", "panoptic_head.mask_decoder",
                                 "panoptic_head.point_emb")) for k in sd)


def _ragged_boxes(rng, n, h, w):
    """Boxes of every kind: inside, crossing each edge, fractional corners,
    degenerate, and wholly outside."""
    xy = rng.uniform(-15, max(h, w), (n, 2))
    wh = rng.uniform(0.3, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0] = (-5.5, -3.2, 20.7, 12.1)
    boxes[1] = (w - 10.3, h - 7.9, w + 6.4, h + 3.3)
    boxes[2] = (5.0, 5.0, 5.0, 9.0)  # zero width
    boxes[3] = (w + 1.0, 2.0, w + 9.0, 8.0)  # outside
    return boxes


def test_paste_masks_matches_jax_bitwise():
    rng = np.random.default_rng(6)
    h, w = 37, 53
    masks = rng.random((24, 28, 28)).astype(np.float32)
    boxes = _ragged_boxes(rng, 24, h, w)
    got = paste_masks_np(masks, boxes, h, w)
    ref = jax_paste_masks_np(masks, boxes, h, w)
    assert got.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got[2:4].any()


def _rcnn_eval_batch():
    """Two images' padded Mask R-CNN output (boxes in the batch input,
    uint8 28^2 maps that fill most of each box) and their GT, whose masks
    fill their boxes."""
    rng = np.random.default_rng(7)
    ori = [(50, 70), (64, 48)]
    metas, gts = [], []
    n = 6
    boxes = np.zeros((2, n, 4), np.float32)
    probs = np.zeros((2, n, 28, 28), np.uint8)
    probs[:, :, 2:26, 2:26] = 230
    probs = np.clip(probs.astype(int) + rng.integers(-20, 20, probs.shape), 0, 255).astype(np.uint8)
    for i, (h, w) in enumerate(ori):
        r = min(64 / h, 64 / w)
        sf = (int(w * r + 0.5) / w, int(h * r + 0.5) / h)
        metas.append(dict(img_id=i, ori_shape=(h, w), batch_input_shape=(64, 64),
                          scale_factor=sf))
        gt_boxes = np.array([[4, 6, 30, 28], [20, 15, 45, 40], [2, 30, 20, 48]], np.float32)
        masks = np.zeros((3, h, w), np.uint8)
        for g, (x1, y1, x2, y2) in enumerate(gt_boxes.astype(int)):
            masks[g, y1:y2, x1:x2] = 1
        gts.append(dict(bboxes=gt_boxes, labels=np.array([0, 1, 0]), masks=masks,
                        iscrowd=np.zeros(3, bool), areas=masks.sum((1, 2)).astype(np.float64)))
        jitter = rng.uniform(-0.5, 0.5, (3, 4)).astype(np.float32)
        boxes[i, :3] = (gt_boxes + jitter) * np.array([sf[0], sf[1]] * 2, np.float32)
        boxes[i, 3:] = _ragged_boxes(rng, 4, 64, 64)[: n - 3]
    scores = rng.uniform(0.3, 1.0, (2, n)).astype(np.float32)
    labels = np.array([[0, 1, 0, 1, 0, 0]] * 2)
    valid = np.ones((2, n), bool)
    return metas, (boxes, scores, labels, valid), probs, gts


def _run_metric(metric, dets_type, data):
    metas, dets, probs, gts = data
    metric.process(metas, dets_type(*dets), probs, gts)
    return metric.compute()


def test_paste_metric_matches_jax():
    """The port's CocoMetric(mask_mode='paste'): every key equal to JAX's."""
    data = _rcnn_eval_batch()
    got = _run_metric(CocoMetric(num_classes=2, mask_mode="paste"), DetResult, data)
    ref = _run_metric(JaxCocoMetric(num_classes=2, mask_mode="paste"), JaxDetResult, data)
    np.testing.assert_equal(got, ref)  # NaN (a size range without GT) equal to NaN
    assert got["coco/segm_mAP"] > 0.25


def test_jax_default_metric_stretches_roi_masks():
    """JAX's tools build CocoMetric without ``mask_mode`` for Mask R-CNN, so
    each 28^2 RoI map is read as a full-frame mask: on detections whose
    maps fill their boxes the segm mAP collapses, where pasting them reads
    the box masks' own mAP (and the bbox mAP is the same)."""
    data = _rcnn_eval_batch()
    default = _run_metric(JaxCocoMetric(num_classes=2), JaxDetResult, data)
    paste = _run_metric(CocoMetric(num_classes=2, mask_mode="paste"), DetResult, data)
    assert default["coco/bbox_mAP"] == paste["coco/bbox_mAP"]
    assert default["coco/segm_mAP"] < paste["coco/segm_mAP"] - 0.25


CONFIGS = sorted(p.name for p in (ROOT / "configs" / "rsprompter").glob("sam*.py"))


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_build(name):
    """Every SAM-det / SAM-seg config builds its family (a tiny encoder);
    SAM-det stays fp32, the SAM-seg configs ask for bf16."""
    assert len(CONFIGS) == 9
    model_cfg = dict(Config.fromfile(str(ROOT / "configs" / "rsprompter" / name))["model"])
    model = build_detector(dict(model_cfg, vision_config=dict(VISION_KW)))
    assert type(model).__name__ == model_cfg["type"]
    assert bool(model_cfg.get("bf16")) == (model_cfg["type"] != "SAMDet")
    if model_cfg["type"] == "SAMDet":
        assert model.segmentor.vision_encoder.config.hidden_size == 32
        assert model.roi_head.mask_head is None and len(model.backbone.layer3) == 6
    else:
        assert model.backbone.config.hidden_size == 32


@pytest.mark.parametrize("mtype", ["SAMDet", "SAMSegMaskRCNN", "SAMSegMask2Former"])
def test_sam_file_loads_into_each_family(tmp_path, mtype):
    """A seeded HF-named SAM file (the tied prompt-encoder embedding left
    out, as HF saves it): every SAM tensor of the detector equals the
    file's, none missing."""
    from test_torch_samdet import SAMDET_TINY

    cfg = {"SAMDet": SAMDET_TINY, "SAMSegMaskRCNN": MASKRCNN_TINY,
           "SAMSegMask2Former": MASK2FORMER_TINY}[mtype]
    port = build_detector(dict(cfg))
    rng = np.random.default_rng(8)
    hf = {}
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES[mtype].items():
        for name, t in port.state_dict().items():
            if name.startswith(prefix):
                hf[hf_prefix + name[len(prefix):]] = torch.from_numpy(
                    rng.standard_normal(tuple(t.shape)).astype(np.float32))
    hf.pop(ck.TIED_KEY, None)
    path = tmp_path / "pytorch_model.bin"
    torch.save(hf, path)
    report = ck.load_sam_pretrained(port, ck.load_torch_checkpoint(str(path)), mtype)
    assert all(r["missing"] == 0 for r in report.values()), report
    hf = ck.tie_shared_embedding(hf)
    n = 0
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES[mtype].items():
        for name, t in port.state_dict().items():
            if name.startswith(prefix):
                assert torch.equal(t, hf[hf_prefix + name[len(prefix):]]), name
                n += 1
    assert n == len(hf)
