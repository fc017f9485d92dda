"""RSPrompter-query predict of the torch port held against the JAX package.

fp32 on both sides, on the CPU, tolerance ``TOL`` = 2e-4 (sums run in
another order). A tiny query model (hidden 128, two heads of 64, two encoder
layers, 128^2 input, six queries, the full six-layer Mask2Former decoder) is
built by the JAX package's ``DetInferencer``; its variables are drawn from a
seed with numpy on the shapes ``jax.eval_shape`` gives (the model's own init
would compile for a minute) and go to the port through
``rsprompter_tpu_torch.utils.convert`` and ``load_state_dict(strict=True)``.
The modules of the path are checked one by one on the same parameters, then
predict end to end through ``inference_detector(..., device='cpu')``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.inference import init_detector as jax_init_detector
from rsprompter_tpu.core.config import Config as JaxConfig
from rsprompter_tpu.models.dense_heads.pixel_decoder import (
    MSDeformAttnPixelDecoder as JaxPixelDecoder,
)
from rsprompter_tpu.models.sam.configs import SamPromptEncoderConfig as JaxPromptConfig
from rsprompter_tpu.models.sam.configs import sam_config as jax_sam_config
from rsprompter_tpu.models.sam.mask_decoder import SamMaskDecoder as JaxMaskDecoder
from rsprompter_tpu.models.sam.prompt_encoder import SamMaskEmbedding as JaxMaskEmbedding
from rsprompter_tpu.models.seg_heads.fusion_head import (
    instance_postprocess as jax_instance_postprocess,
)
from rsprompter_tpu.ops.msdeform_attn import ms_deform_attn_core as jax_ms_deform_attn_core
from rsprompter_tpu.ops.sampling import grid_sample_nhwc as jax_grid_sample_nhwc
from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.models.seg_heads.fusion_head import instance_postprocess
from rsprompter_tpu_torch.ops.msdeform_attn import ms_deform_attn_core
from rsprompter_tpu_torch.ops.sampling import grid_sample_nhwc
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

TOL = 2e-4  # fp32 on both sides; sums run in another order

TINY = dict(
    type="RSPrompterQuery",
    bf16=False,
    num_classes=3,
    prompt_shape=(6, 5),
    image_size=128,
    select_layers=(1, 2),
    aggregator_hidden=8,
    vision_config=dict(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        global_attn_indexes=(1,), image_size=128, patch_size=16, window_size=3,
        output_channels=32,
    ),
    test_cfg=dict(max_per_image=8),
)
CFG = {"model": TINY, "crop_size": (128, 128)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, ref, what=""):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(ref, np.float32), atol=TOL, rtol=TOL,
        err_msg=what,
    )


# The query family's JAX references (transformer decoders, large programs)
# compile without LLVM's optimisations: about a quarter less compile time for
# the query train step at a fraction of a second more run time (for the
# conv-heavy anchor step the slower run costs what the compile saves)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _random_variables(shapes, rng):
    """Weights on the JAX tree's shapes: kernels N(0, 1/fan_in), variances
    positive, every other leaf (biases, norms' scales, embeddings, rel-pos
    tables, the level encodings) N(0, 0.5), so no path is an identity."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return (np.abs(rng.standard_normal(leaf.shape)) + 0.5).astype(np.float32)
        return (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def query():
    """The JAX inferencer, its variables, and the port's detector on them."""
    rng = np.random.default_rng(0)
    jinf = jax_init_detector(JaxConfig.fromdict(CFG), batch_size=2)
    images = np.zeros((2, 128, 128, 3), np.uint8)
    shapes = jax.eval_shape(lambda: jinf.model.init(
        {"params": jax.random.PRNGKey(0)}, {"images": images}, method="predict"))
    variables = _random_variables(shapes, rng)
    model = init_detector(Config.fromdict(CFG), checkpoint=jax_to_state_dict(variables),
                          device="cpu")
    return dict(jinf=jinf, variables=variables, params=variables["params"], model=model,
                det=model.model)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    """Bilinear, zero padding; a third of the points lie outside the map."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.5, 1.5, (2, 40, 2)).astype(np.float32)
    ref = jax.jit(jax_grid_sample_nhwc, static_argnums=2)(img, grid, align_corners)
    _close(grid_sample_nhwc(_t(img), _t(grid), align_corners), ref)


def test_ms_deform_attn_core_matches_jax():
    rng = np.random.default_rng(2)
    b, q, nh, hd, npt = 2, 11, 4, 8, 3
    hws = [(2, 3), (4, 5), (8, 7)]
    values = [rng.standard_normal((b, h, w, nh, hd)).astype(np.float32) for h, w in hws]
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(hws), npt, 2)).astype(np.float32)
    weights = rng.random((b, q, nh, len(hws), npt)).astype(np.float32)
    ref = jax.jit(jax_ms_deform_attn_core)(values, locs, weights)
    _close(ms_deform_attn_core([_t(v) for v in values], _t(locs), _t(weights)), ref)


def test_pixel_decoder_matches_jax(query):
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((2, s, s, 256)).astype(np.float32) for s in (32, 16, 8, 4, 2)]
    jdec = JaxPixelDecoder(feat_channels=128, out_channels=32, num_encoder_levels=3,
                           num_outs=3)
    j_mask, j_mem = jax.jit(jdec.apply)(
        {"params": query["params"]["panoptic_head"]["pixel_decoder"]}, feats)
    with torch.no_grad():
        t_mask, t_mem = query["det"].panoptic_head.pixel_decoder([_t(f) for f in feats])
    _close(t_mask, j_mask, "mask_feature")
    assert [tuple(m.shape[1:3]) for m in t_mem] == [(2, 2), (4, 4), (8, 8)]
    for i, (a, b) in enumerate(zip(t_mem, j_mem)):
        _close(a, b, f"memory {i}")


def test_mask_embedding_matches_jax(query):
    masks = np.random.default_rng(4).standard_normal((5, 32, 32, 1)).astype(np.float32) * 3
    ref = jax.jit(JaxMaskEmbedding(config=JaxPromptConfig(hidden_size=32)).apply)(
        {"params": query["params"]["panoptic_head"]["sam_mask_embed"]}, masks)
    with torch.no_grad():
        _close(query["det"].panoptic_head.sam_mask_embed(_t(masks)), ref)


def test_mask_decoder_per_prompt_dense_matches_jax(query):
    """The decoder_plus case: a dense prompt of its own for every prompt."""
    rng = np.random.default_rng(5)
    b, p, s, c = 2, 3, 8, 32
    emb = rng.standard_normal((b, s, s, c)).astype(np.float32)
    pe = rng.standard_normal((b, s, s, c)).astype(np.float32)
    sparse = rng.standard_normal((b, p, 5, c)).astype(np.float32)
    dense = rng.standard_normal((b, p, s, s, c)).astype(np.float32)
    cfg = dataclasses.replace(jax_sam_config("base").mask_decoder_config, hidden_size=c)
    j_masks, j_iou = jax.jit(JaxMaskDecoder(config=cfg).apply)(
        {"params": query["params"]["panoptic_head"]["mask_decoder"]}, emb, pe, sparse, dense)
    with torch.no_grad():
        t_masks, t_iou = query["det"].panoptic_head.mask_decoder(
            *(_t(a) for a in (emb, pe, sparse, dense)))
    assert t_masks.shape == (b, p, 1, 4 * s, 4 * s)
    _close(t_masks, j_masks, "masks")
    _close(t_iou, j_iou, "iou")


def test_head_logits_every_layer_match_jax(query):
    """Class and SAM mask logits after every decoder layer (each layer's
    prompts decoded), from the same encoder input."""
    pixels = np.random.default_rng(7).standard_normal((2, 128, 128, 3)).astype(np.float32)

    def every_layer(m, x):  # every layer's prompts decoded, in one decoder call
        return m.panoptic_head(*m.extract_feat(x), batch_decode=True)[:2]

    run = jax.jit(lambda v, x: query["jinf"].model.apply(v, x, method=every_layer))
    j_cls, j_masks = run.lower(query["variables"], pixels).compile(
        compiler_options=FAST_COMPILE)(query["variables"], pixels)
    det = query["det"]
    with torch.no_grad():
        t_cls, t_masks = det.panoptic_head(*det.extract_feat(_t(pixels)))
    assert len(t_cls) == len(j_cls) == 7
    for i in range(7):
        _close(t_cls[i], j_cls[i], f"class logits, layer {i}")
        _close(t_masks[i], j_masks[i], f"mask logits, layer {i}")


def test_instance_postprocess_matches_jax():
    """Top-k over query x class with tied scores (two equal queries), the
    mask rescoring and mask2bbox, with an empty mask among the picks."""
    rng = np.random.default_rng(6)
    q, nc, h = 7, 4, 16
    cls = rng.standard_normal((2, q, nc + 1)).astype(np.float32)
    cls[:, 3] = cls[:, 1]  # ties: jax.lax.top_k keeps the lower index first
    masks = rng.standard_normal((2, q, h, h)).astype(np.float32) * 4
    masks[:, 2] = -5.0  # an empty mask
    dets, probs = instance_postprocess(_t(cls), _t(masks), nc, max_per_image=12,
                                       scale_boxes=4.0)
    post = jax.jit(jax.vmap(lambda c, m: jax_instance_postprocess(c, m, nc, 12, 4.0)))
    j_dets, j_probs = post(cls, masks)
    for i in range(2):
        jd = jax.tree_util.tree_map(lambda a: a[i], j_dets)
        jp = j_probs[i]
        np.testing.assert_array_equal(dets.labels[i].numpy(), np.asarray(jd.labels))
        np.testing.assert_array_equal(dets.valid[i].numpy(), np.asarray(jd.valid))
        _close(dets.scores[i], jd.scores, "scores")
        _close(dets.boxes[i], jd.boxes, "boxes")
        _close(probs[i], jp, "probs")


def test_query_predict_matches_jax(query):
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(2)]
    jinf, variables = query["jinf"], query["variables"]
    with pytest.MonkeyPatch.context() as mp:  # the inferencer's init returns them
        mp.setattr(type(jinf.model), "init", lambda self, *a, **k: variables)
        j_preds = jinf(imgs)["predictions"]
    t_preds = inference_detector(query["model"], imgs)
    assert len(j_preds) == len(t_preds) == 2
    for jp, tp in zip(j_preds, t_preds):
        assert len(jp["scores"]) > 0
        _close(tp["scores"], jp["scores"], "scores")
        np.testing.assert_array_equal(tp["labels"], np.asarray(jp["labels"]))
        np.testing.assert_allclose(
            tp["bboxes"], np.asarray(jp["bboxes"], np.float32).reshape(-1, 4), atol=1e-2,
            rtol=TOL,  # pixel coordinates up to 128
        )
        assert tp["masks"].shape == jp["masks"].shape
        # thresholded masks: a few boundary pixels may sit within rounding of 0.5
        assert (tp["masks"] != jp["masks"]).mean() < 1e-3


def test_query_parameters_take_mmdet_names(query):
    sd = query["det"].state_dict()
    pd = "panoptic_head.pixel_decoder."
    for key in ("input_convs.0.conv.weight", "input_convs.2.gn.weight",
                "lateral_convs.1.conv.weight", "output_convs.0.gn.bias",
                "encoder.layers.2.ffn.layers.0.0.weight", "encoder.layers.0.norms.1.weight"):
        assert pd + key in sd, key
    assert tuple(sd[pd + "level_encoding.weight"].shape) == (3, 128)
    enc = query["params"]["panoptic_head"]["pixel_decoder"]
    np.testing.assert_array_equal(sd[pd + "level_encoding.weight"][2].numpy(),
                                  enc["level_encoding_2"])
    assert "panoptic_head.transformer_decoder.layers.5.cross_attn.q_proj.weight" in sd
    assert "panoptic_head.transformer_decoder.post_norm.weight" in sd
