"""SAM-det predict of the torch port held against the JAX package.

fp32 on both sides, on the CPU, tolerance ``TOL`` = 2e-4 relative (sums run
in another order); box corners, pixel coordinates up to 128, take 1e-2
absolute besides. The JAX modules' variables are drawn from a seed with
numpy on the shapes ``jax.eval_shape`` gives (kernels N(0, 1/fan_in), BN
variances positive, every other leaf N(0, 0.5)) and go to the port through
``rsprompter_tpu_torch.utils.convert`` and ``load_state_dict(strict=True)``.
The modules of the path one by one -- ResNet-18 (and ResNet-50 at 64^2),
FPN, the SAM prompt encoder on each kind of prompt, the whole SAM (single
and multimask) -- then ``SAMDet.predict`` and ``oracle_predict`` end to end
at 128^2 (ResNet-18, a SAM of hidden 32), and ``tools.test --oracle`` on a
synthetic COCO set, which must read ``coco/bbox_mAP`` 1.0: the ground-truth
boxes at score 1 are perfect detections.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.models.backbones.resnet import ResNet as JaxResNet
from rsprompter_tpu.models.detectors.samdet import SAMDet as JaxSAMDet
from rsprompter_tpu.models.necks.fpn import FPN as JaxFPN
from rsprompter_tpu.models.sam import configs as jcfg
from rsprompter_tpu.models.sam.prompt_encoder import SamPromptEncoder as JaxPromptEncoder
from rsprompter_tpu.models.sam.sam import SamModel as JaxSamModel
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.models.backbones.resnet import ResNet
from rsprompter_tpu_torch.models.detectors.samdet import sam_config_for
from rsprompter_tpu_torch.models.necks.fpn import FPN
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.prompt_encoder import SamPromptEncoder
from rsprompter_tpu_torch.models.sam.sam import SamModel
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_query import _random_variables

TOL = 2e-4  # fp32 on both sides; sums run in another order
BOX_ATOL = 1e-2  # box corners, pixel coordinates up to 128
IMAGE = 128
VISION_KW = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, global_attn_indexes=(1,),
    image_size=IMAGE, patch_size=16, window_size=3, output_channels=32, num_pos_feats=16,
)
TEST_CFG = dict(
    rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
    rcnn=dict(score_thr=0.0, nms_iou_thr=0.5, max_per_img=8, nms_pre=40),
)
SAMDET_TINY = dict(type="SAMDet", num_classes=3, resnet_depth=18, image_size=IMAGE,
                   vision_config=VISION_KW, test_cfg=TEST_CFG)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref, what="", atol=TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(ref, np.float32), atol=atol, rtol=TOL,
        err_msg=what,
    )


def jax_sam_config():
    """JAX's SamConfig of the tiny SAM (the port's ``sam_config_for``)."""
    return jcfg.SamConfig(
        vision_config=jcfg.SamVisionConfig(**VISION_KW),
        prompt_encoder_config=jcfg.SamPromptEncoderConfig(hidden_size=32, image_size=IMAGE),
        mask_decoder_config=dataclasses.replace(
            jcfg.sam_config("base").mask_decoder_config, hidden_size=32),
    )


def _draw(module, *args, seed=0, **kwargs):
    """Seeded numpy variables on the JAX module's init shapes."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _random_variables(shapes, np.random.default_rng(seed))


def _every_prompt(b, p):
    """Prompts that between them reach every prompt-encoder parameter (flax
    creates a submodule's parameters only where a call reaches it)."""
    s = 4 * IMAGE // 16
    return (dict(input_points=np.zeros((b, p, 1, 2), np.float32),
                 input_labels=np.zeros((b, p, 1), np.int32),
                 input_boxes=np.zeros((b, p, 4), np.float32)),
            dict(input_masks=np.zeros((b, s, s, 1), np.float32)))


def _init_prompt_encoder(m, b, p):
    for kw in _every_prompt(b, p):
        m(**kw)


def _init_sam(m, pixels):
    """The whole SAM on the prompts that reach every parameter."""
    prompts, masks = _every_prompt(pixels.shape[0], 2)
    m(pixel_values=pixels, **prompts)
    m(pixel_values=pixels, input_boxes=prompts["input_boxes"], **masks)


def _init_samdet(m, batch):
    m.predict(batch)
    _init_sam(m.segmentor, batch["images"].astype(np.float32))


def _port(module, variables):
    module.load_state_dict(jax_to_state_dict(variables), strict=True)
    return module.eval()


def _images(seed, n=2, size=IMAGE):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("depth,size", [(18, 128), (50, 64)])
def test_resnet_matches_jax(depth, size):
    """The C2..C5 maps, BN frozen at its running statistics (also in the
    port's train mode)."""
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    jmod = JaxResNet(depth=depth)
    variables = _draw(jmod, x)
    ref = jax.jit(jmod.apply)(variables, x)
    port = _port(ResNet(depth), variables).train()
    with torch.no_grad():
        got = port(_t(x))
    assert len(got) == 4
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        _close(a, b, f"stage {i}")
    assert "layer2.0.downsample.1.running_var" in port.state_dict()


def test_fpn_matches_jax():
    """ResNet-18's four widths at ragged sizes: the top-down path's nearest
    upsample at ratios other than 2 (half-pixel centres), and the fifth
    level."""
    rng = np.random.default_rng(2)
    inputs = [rng.standard_normal((2, s, s + 1, c)).astype(np.float32)
              for s, c in ((17, 64), (9, 128), (5, 256), (3, 512))]
    jmod = JaxFPN()
    variables = _draw(jmod, inputs)
    ref = jax.jit(jmod.apply)(variables, inputs)
    port = _port(FPN((64, 128, 256, 512)), variables)
    with torch.no_grad():
        got = port([_t(x) for x in inputs])
    assert len(got) == 5
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        _close(a, b, f"level {i}")
    assert "lateral_convs.3.conv.weight" in port.state_dict()


PROMPTS = ["points", "boxes", "points_boxes", "masks"]


@pytest.mark.parametrize("kind", PROMPTS)
def test_prompt_encoder_matches_jax(kind):
    """Sparse and dense embeddings of each kind of prompt; the labels cover
    1, 0, -1 (not a point) and -10 (padding)."""
    rng = np.random.default_rng(3)
    cfg = dict(hidden_size=32, image_size=IMAGE)
    b, p = 2, 3
    args = dict(
        input_points=rng.uniform(0, IMAGE, (b, p, 4, 2)).astype(np.float32),
        input_labels=np.tile(np.array([1, 0, -1, -10], np.int32), (b, p, 1)),
        input_boxes=np.sort(rng.uniform(0, IMAGE, (b, p, 2, 2)), axis=2)
        .reshape(b, p, 4).astype(np.float32),
        input_masks=rng.standard_normal((b, 4 * IMAGE // 16, 4 * IMAGE // 16, 1))
        .astype(np.float32),
    )
    keys = {"points": ("input_points", "input_labels"), "boxes": ("input_boxes",),
            "points_boxes": ("input_points", "input_labels", "input_boxes"),
            "masks": ("input_boxes", "input_masks")}[kind]
    kw = {k: args[k] for k in keys}
    jmod = JaxPromptEncoder(config=jcfg.SamPromptEncoderConfig(**cfg))
    variables = _draw(jmod, b, p, method=_init_prompt_encoder)
    j_sparse, j_dense = jmod.apply(variables, **kw)
    from rsprompter_tpu_torch.models.sam.configs import SamPromptEncoderConfig

    port = _port(SamPromptEncoder(SamPromptEncoderConfig(**cfg)), variables)
    with torch.no_grad():
        t_sparse, t_dense = port(**{k: torch.from_numpy(v) for k, v in kw.items()})
    assert t_sparse.shape == j_sparse.shape and t_dense.shape == j_dense.shape
    _close(t_sparse, j_sparse, "sparse")
    _close(t_dense.detach(), j_dense, "dense")


@pytest.fixture(scope="module")
def sam():
    """The tiny JAX SamModel, its variables and the port's SamModel on them."""
    rng = np.random.default_rng(4)
    pixels = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    boxes = np.sort(rng.uniform(0, IMAGE, (2, 5, 2, 2)), axis=2).reshape(2, 5, 4)
    jmod = JaxSamModel(config=jax_sam_config())
    variables = _draw(jmod, pixels, method=_init_sam, seed=5)
    port = _port(SamModel(sam_config_for("base", IMAGE, SamVisionConfig(**VISION_KW))),
                 variables)
    return dict(jmod=jmod, variables=variables, port=port, pixels=pixels,
                boxes=boxes.astype(np.float32))


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
def test_sam_model_matches_jax(sam, multimask):
    """Box prompts through the whole SAM: masks (B, P, M, 4h, 4w), IoU."""
    j_masks, j_iou = jax.jit(
        lambda v, x, bx: sam["jmod"].apply(v, pixel_values=x, input_boxes=bx,
                                           multimask_output=multimask)
    )(sam["variables"], sam["pixels"], sam["boxes"])
    with torch.no_grad():
        t_masks, t_iou = sam["port"](pixel_values=_t(sam["pixels"]), input_boxes=_t(sam["boxes"]),
                                     multimask_output=multimask)
    m = 3 if multimask else 1
    assert t_masks.shape == j_masks.shape == (2, 5, m, 32, 32)
    _close(t_masks, j_masks, "masks")
    _close(t_iou, j_iou, "iou")
    names = sam["port"].state_dict()
    for key in ("shared_image_embedding.positional_embedding",
                "prompt_encoder.shared_embedding.positional_embedding",
                "prompt_encoder.point_embed.3.weight", "prompt_encoder.not_a_point_embed.weight",
                "prompt_encoder.mask_embed.conv1.weight", "mask_decoder.iou_token.weight",
                "vision_encoder.layers.1.attn.rel_pos_h"):
        assert key in names, key


@pytest.fixture(scope="module")
def samdet():
    """JAX's SAMDet on the tiny SAM and ResNet-18, its variables and the
    port's detector from ``build_detector`` on them, with a batch that
    carries ground truth."""
    rng = np.random.default_rng(6)
    batch = dict(images=_images(7), img_shape=np.array([[IMAGE, IMAGE], [100, 120]], np.int32))
    gt = np.array([[[10, 12, 60, 70], [40, 30, 120, 90], [0, 0, 0, 0]],
                   [[5, 50, 45, 99], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    batch.update(gt_bboxes=gt, gt_labels=np.array([[2, 0, 0], [1, 0, 0]], np.int32),
                 gt_valid=np.array([[True, True, False], [True, False, False]]))
    jmod = JaxSAMDet(sam_cfg=jax_sam_config(), image_size=IMAGE, num_classes=3,
                     resnet_depth=18, test_cfg=TEST_CFG)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, batch, method=_init_samdet))
    variables = _random_variables(shapes, rng)
    port = _port(build_detector(dict(SAMDET_TINY)), variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return dict(jmod=jmod, variables=variables, port=port, batch=batch, tbatch=tbatch)


@pytest.mark.parametrize("method", ["predict", "oracle_predict"])
def test_samdet_predict_matches_jax(samdet, method):
    """Detections (boxes, scores within tolerance; labels and valid equal)
    and the 4h x 4w mask probabilities of every valid slot."""
    j_dets, j_probs = jax.jit(lambda v, b: samdet["jmod"].apply(v, b, method=method))(
        samdet["variables"], samdet["batch"])
    t_dets, t_probs = getattr(samdet["port"], method)(samdet["tbatch"])
    valid = np.asarray(j_dets.valid)
    np.testing.assert_array_equal(t_dets.valid.numpy(), valid)
    assert valid.sum() > 2
    np.testing.assert_array_equal(t_dets.labels.numpy()[valid], np.asarray(j_dets.labels)[valid])
    _close(t_dets.scores.numpy()[valid], np.asarray(j_dets.scores)[valid], "scores")
    _close(t_dets.boxes.numpy()[valid], np.asarray(j_dets.boxes)[valid], "boxes", BOX_ATOL)
    assert t_probs.shape == j_probs.shape == (2, valid.shape[1], 32, 32)
    _close(t_probs.numpy()[valid], np.asarray(j_probs)[valid], "mask probs")
    if method == "oracle_predict":
        b = samdet["batch"]
        np.testing.assert_array_equal(t_dets.scores.numpy(), b["gt_valid"].astype(np.float32))
        np.testing.assert_array_equal(t_dets.labels.numpy(), b["gt_labels"])


def test_tool_oracle_reads_bbox_map_one(tmp_path):
    """``tools.test --oracle --device cpu``: the GT boxes, scaled into the
    batch input and back, are every detection; bbox mAP 1.0."""
    import cv2

    from rsprompter_tpu_torch.tools import test as tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco
    from test_torch_eval import CLASSES

    root = synthetic_coco(str(tmp_path / "coco"), CLASSES,
                          ((64, 80), (70, 64), (60, 90)), cv2.imwrite)
    model = dict(SAMDET_TINY, num_classes=len(CLASSES), image_size=64,
                 vision_config=dict(VISION_KW, image_size=64, patch_size=8, window_size=4))
    ds = dict(type="NWPUInsSegDataset", data_root=root, ann_file="ann.json",
              data_prefix=dict(img="imgs"), test_mode=True)
    cfg = tmp_path / "samdet_oracle.py"
    cfg.write_text(f"model = {model!r}\ncrop_size = (64, 64)\n"
                   f"val_dataloader = dict(batch_size=2, dataset={ds!r})\n")
    report = tool.main([str(cfg), "--oracle", "--device", "cpu"])
    assert report["metrics"]["coco/bbox_mAP"] == 1.0
    assert np.isfinite(report["metrics"]["coco/segm_mAP"])
    with pytest.raises(SystemExit, match="oracle_predict"):
        cfg.write_text(cfg.read_text().replace("'SAMDet'", "'SAMSegMaskRCNN'"))
        tool.main([str(cfg), "--oracle", "--device", "cpu"])
