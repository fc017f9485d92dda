"""SAM-seg Mask R-CNN, SAM-seg Mask2Former and RSPrompter-query with
``decoder_plus=False`` training of the torch port held against the JAX
package.

fp32 on both sides, on the CPU; tiny models (an encoder of hidden 32 for
Mask R-CNN, the query train test's of hidden 128 for the Mask2Former
heads; 128^2 input). JAX's variables are drawn with numpy on
``jax.eval_shape``'s shapes and carried to the port through
``utils/convert.py``; each side differentiates its own ``total_loss``; the
samplers and point draws take the uniforms of JAX's own key splits. Held:

- ``SAMSegMaskRCNN.loss`` with the multi-layer aggregator and a frozen
  encoder, and with the pseudo aggregator and LoRA (``peft_config``: the
  encoder under autograd): the RPN, bbox and FCN mask terms within
  ``TOL`` = 2e-4 relative, every parameter's gradient within ``TOL`` of
  its largest magnitude (the frozen encoder's absent in the port, zero in
  JAX);
- SAM-seg Mask2Former (the stock head): the 21 loss terms (``loss_cls``,
  ``loss_mask``, ``loss_dice`` of 7 head calls), the 7 x B matches, the
  selected points and every gradient, on the query train test's machinery
  (``test_torch_query_train._run_case``) and its rules, the encoder frozen;
- RSPrompter-query with ``decoder_plus=False`` (JAX's module built with it:
  JAX's ``build_detector`` drops the key, a fault of the reference package
  that ``test_jax_builder_drops_decoder_plus`` shows): every head call's
  class and mask logits and predict's detections within ``TOL``; the 21
  loss terms, the matches, the points and every gradient as above;
- one ``Trainer.train_step`` per family on the CPU: every frozen tensor
  bitwise unchanged, every trained tensor the loss reaches moved; with
  ``peft_config`` the adapters are the encoder's only trained tensors.

Each loss test prints the worst relative errors it saw (``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_query_train as qt
from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.engine.train_state import total_loss as jax_total_loss
from rsprompter_tpu.models.seg_heads.fusion_head import (
    instance_postprocess as jax_instance_postprocess,
)
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.engine.train_state import build_trainer, total_loss
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

from test_torch_query import FAST_COMPILE, _random_variables
from test_torch_samdet_train import (
    MAX_GT,
    N_ANCHORS,
    N_PROPOSALS,
    SAMPLES,
    TOL,
    TRAIN_CFG,
    check_gradients,
    check_losses,
    jax_draws,
)
from test_torch_samseg import MASKRCNN_TINY, _compare_dets

IMAGE = 128
MASKRCNN_TRAIN = dict(MASKRCNN_TINY, train_cfg=TRAIN_CFG, **SAMPLES)
PEFT = dict(peft_config=dict(r=4, lora_alpha=8, target_modules=["qkv"]),
            aggregator_type="pseudo")
MASKRCNN_CASES = {
    "multi": dict(MASKRCNN_TRAIN),
    "pseudo_lora": dict(MASKRCNN_TRAIN, **PEFT),
}
RCNN_TERMS = {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc", "loss_mask"}
ONE_STREAM_TERMS = ("loss_cls", "loss_mask", "loss_dice")
# the query train test's config with the encoder frozen (its gradient is
# that test's): the heads' backward alone, which compiles in less time
MASK2FORMER = dict(qt.TINY, type="SAMSegMask2Former", train_backbone=False)
NO_PLUS = dict(qt.TINY, decoder_plus=False, train_backbone=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_query_model(cfg):
    """JAX's detector for ``cfg``, with ``decoder_plus`` as the config says
    (JAX's ``build_detector`` leaves its module default, True)."""
    model = jax_build_detector(dict(cfg))
    if cfg["type"] == "RSPrompterQuery":
        model = model.clone(decoder_plus=cfg.get("decoder_plus", True))
    return model


# --- SAM-seg Mask R-CNN ----------------------------------------------------------


@pytest.mark.parametrize("case", list(MASKRCNN_CASES))
def test_maskrcnn_loss_matches_jax(case):
    cfg = MASKRCNN_CASES[case]
    rng = np.random.default_rng(11)
    batch = synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmod = jax_build_detector(dict(cfg))
    key = jax.random.PRNGKey(8)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, key, method="loss"))
    variables = _random_variables(shapes, rng)

    def loss_fn(p):
        out, _ = jmod.apply({**variables, "params": p}, jbatch, key, method="loss",
                            mutable=["batch_stats"])
        return jax_total_loss(out), out

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    port = build_detector(dict(cfg))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    port.train()
    draws = jax_draws(key, 2, {"rpn": N_ANCHORS, "roi": MAX_GT + N_PROPOSALS})
    tlosses = port.loss({k: _t(v) for k, v in batch.items()}, draws=draws)
    total_loss(tlosses).backward()
    worst_l = check_losses({k: float(v) for k, v in jlosses.items()},
                           {k: float(v.detach()) for k, v in tlosses.items()}, RCNN_TERMS)
    assert float(tlosses["loss_mask"].detach()) > 0
    tg = {n: p.grad for n, p in port.named_parameters()}
    worst_g = check_gradients(
        jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}), tg)
    lora = "peft_config" in cfg
    enc = {n: g for n, g in tg.items() if n.startswith("backbone.")}
    assert all((g is not None) == lora for g in enc.values())
    for part in ("neck_feature_aggregator", "neck_feature_spliter", "rpn_head",
                 "roi_head.bbox_head", "roi_head.mask_head.conv_logits") + (
                     ("qkv_lora_a", "qkv_lora_b") if lora else ()):
        assert any(part in n and g is not None for n, g in tg.items()), part
    print(f"SAMSegMaskRCNN.loss ({case}): worst loss rel err {worst_l:.3g}, "
          f"gradient {worst_g}")


# --- the Mask2Former heads with one mask stream ------------------------------------


def _check_one_stream_losses(case):
    jl_, tl_ = case["jlosses"], case["tlosses"]
    names = {p + t for p in [f"d{i}." for i in range(qt.N_CALLS - 1)] + [""]
             for t in ONE_STREAM_TERMS}
    assert len(names) == 21
    worst = check_losses(jl_, tl_, names)
    assert all(v > 0 for v in tl_.values())
    return worst


def _check_one_stream_points(case):
    """The importance-sampled coordinates of the one stream, every call."""
    jc, tc = case["rec"]["coords"], case["got"]["coords"]
    assert sorted(jc) == list(range(qt.N_CALLS)) and len(tc) == 1
    port = tc[0].numpy().reshape(qt.N_CALLS, 2 * MAX_GT, qt.NUM_POINTS, 2)
    for li in range(qt.N_CALLS):
        np.testing.assert_array_equal(port[li], jc[li], err_msg=f"call {li}")


def _one_stream_step(monkeypatch, cfg):
    monkeypatch.setattr(qt, "TINY", cfg)
    monkeypatch.setattr(qt, "jax_build_detector", jax_query_model)
    case = qt._run_case()
    worst = _check_one_stream_losses(case)
    qt._check_matches(case)
    _check_one_stream_points(case)
    return case, worst


def test_mask2former_step_matches_jax(monkeypatch):
    """The stock head: matched on its own masks (the mask-feature product),
    ``loss_cls`` with its linear ``cls_embed``, point-sampled BCE and dice
    of the matched queries' masks."""
    case, worst = _one_stream_step(monkeypatch, MASK2FORMER)
    qt._check_gradients(case, parts=("pixel_decoder", "mask_embed", "cls_embed",
                                     "transformer_decoder", "neck_feature_aggregator"))
    assert not any("mask_decoder" in n or "point_emb" in n for n in case["tgrads"])
    print(f"SAM-seg Mask2Former step: worst loss rel err {worst:.3g}")


def test_no_plus_step_matches_jax(monkeypatch):
    """``decoder_plus=False``: each call's SAM decode of every query is the
    next attention mask's source and what the match reads; the SAM stream's
    terms alone, the dense prompt ``no_mask_embed`` (trained here:
    ``decoder_freeze=False``)."""
    case, worst = _one_stream_step(monkeypatch, NO_PLUS)
    qt._check_gradients(case, parts=("mask_decoder", "point_emb", "cls_embed", "no_mask_embed",
                                     "shared_image_embedding", "transformer_decoder"))
    assert not any("mask_embed." in n and "no_mask" not in n for n in case["tgrads"])
    print(f"decoder_plus=False step: worst loss rel err {worst:.3g}")


def test_no_plus_predict_matches_jax():
    """Every head call's class logits and SAM mask logits (each call decodes
    all its queries), then predict's top-k detections and masks. The seed
    draws weights whose SAM masks reach above 0.5 somewhere, so that predict
    has non-empty instances to compare (about half the seeds do)."""
    cfg = dict(qt.QUERY_TINY, decoder_plus=False)
    jmod = jax_query_model(cfg)
    rng = np.random.default_rng(13)
    batch = {"images": rng.integers(0, 256, (2, IMAGE, IMAGE, 3), dtype=np.uint8)}
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    variables = _random_variables(shapes, rng)
    tensor = jax.jit(lambda v, b: jmod.apply(v, b, method="tensor"))
    j_cls, j_masks = tensor.lower(variables, batch).compile(compiler_options=FAST_COMPILE)(
        variables, batch)
    # JAX's predict is its fusion head on the last call's logits
    j_dets, j_probs = jax.vmap(lambda c, m: jax_instance_postprocess(
        c, m, 3, cfg["test_cfg"]["max_per_image"], scale_boxes=IMAGE / m.shape[-1]))(
        j_cls[-1], j_masks[-1])
    port = build_detector(dict(cfg))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    port.eval()
    tbatch = {"images": _t(batch["images"])}
    with torch.no_grad():
        feats, emb, pe = port.extract_feat(tbatch["images"])
        t_cls, t_masks = port.panoptic_head(feats, emb, pe)
    assert len(t_cls) == len(t_masks) == len(j_cls) == qt.N_CALLS
    worst = 0.0
    for i, (a, b, c, d) in enumerate(zip(t_cls, t_masks, j_cls, j_masks)):
        assert b.shape == d.shape == (2, 6, 32, 32)
        for got, ref, what in ((a, c, "class"), (b, d, "mask")):
            err = float(np.abs(got.numpy() - np.asarray(ref)).max()
                        / np.abs(np.asarray(ref)).max())
            assert err <= TOL, (i, what, err)
            worst = max(worst, err)
    t_dets, t_probs = port.predict(tbatch)
    _compare_dets(t_dets, t_probs, j_dets, j_probs)
    print(f"decoder_plus=False predict: worst logit rel err {worst:.3g}")


def test_jax_builder_drops_decoder_plus():
    """A fault of the reference package (ROADMAP Queue C): JAX's
    ``build_detector`` passes no ``decoder_plus`` to ``RSPrompterQuery``, so
    a config with ``decoder_plus=False`` builds the plus-stream head there
    (its ``mask_embed`` and ``sam_mask_embed``, no ``no_mask_embed``). The
    port builds what the config says; the tests above build JAX's module
    with the key themselves (``jax_query_model``)."""
    jmod = jax_build_detector(dict(NO_PLUS))
    assert jmod.decoder_plus is True
    assert jax_query_model(dict(NO_PLUS)).decoder_plus is False
    head = build_detector(dict(NO_PLUS)).panoptic_head
    assert head.chain_decodes and hasattr(head, "no_mask_embed")
    assert not hasattr(head, "mask_embed") and not hasattr(head, "sam_mask_embed")


# --- the trainers ----------------------------------------------------------------------


# the two finest neck levels and the pixel decoder's path to the mask
# feature: only the mask-feature product reads them
MASK_FEATURE_BRANCH = tuple(
    f"neck_feature_spliter.{m}" for m in ("fpn1", "fpn2", "lateral_convs.0", "lateral_convs.1",
                                          "fpn_convs.0", "fpn_convs.1")
) + tuple(f"panoptic_head.pixel_decoder.{m}" for m in ("lateral_convs", "output_convs",
                                                         "mask_feature"))
TRAINER_CASES = {
    "samseg_maskrcnn": dict(MASKRCNN_TRAIN),
    "samseg_maskrcnn_peft": dict(MASKRCNN_TRAIN, **PEFT),
    "samseg_mask2former": dict(MASK2FORMER, train_backbone=False),
    "query_no_plus": dict(NO_PLUS, train_backbone=False, decoder_freeze=True),
}


@pytest.mark.parametrize("name", list(TRAINER_CASES))
def test_trainer_step_moves_the_trained_alone(name):
    cfg = TRAINER_CASES[name]
    trainer = build_trainer({"model": cfg, "base_lr": 1e-3, "warmup_iters": 0},
                            device="cpu", seed=0)
    model, opt = trainer.model, trainer.optimizer
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: _t(v) for k, v in synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT,
                                                  seed=9).items()}
    metrics = trainer.train_step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    frozen = {n for n, _ in opt.frozen}
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        if n in frozen:
            assert not moved, n
        elif n not in opt.unreached:
            assert moved, n
    trained_enc = {n for n, _ in opt.trained if n.startswith("backbone.")}
    if "peft_config" in cfg:
        assert trained_enc == {n for n in before if "qkv_lora" in n} != set()
    else:
        assert trained_enc == set()
        assert all(p.grad is None for n, p in model.named_parameters()
                   if n.startswith("backbone."))
    if name == "query_no_plus":  # the mask-feature branch feeds nothing there (JAX's too)
        assert opt.unreached and all(n.startswith(MASK_FEATURE_BRANCH)
                                     for n in opt.unreached), opt.unreached
    else:
        assert opt.unreached == []
