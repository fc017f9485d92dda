"""SAM-det training and the standard RoI head's loss of the torch port held
against the JAX package.

fp32 on both sides, on the CPU. The JAX modules' variables are drawn from a
seed with numpy on ``jax.eval_shape``'s shapes (as ``test_torch_samdet.py``
draws them) and go to the port through ``utils/convert.py``; the samplers
take the uniforms of JAX's own key splits (``jax_draws``, as
``test_torch_train.py`` passes them). Held:

- the single-level ``roi_align`` at ``aligned`` True and False and
  ``sampling_ratio`` 1 and 2, over boxes that cross the border and boxes
  narrower than a pixel: in float64 on both sides within 1e-6 of the
  largest output (it reads about 5e-15), and in fp32 within
  ``ROI_FP32_TOL`` = 1e-5 of it (it reads 1.1e-6 to 2.3e-6: the sample
  coordinates round at fp32's 2e-6 for boxes near 40 pixels, and each
  side is about 2e-6 of the largest output from the float64 values);
  ``mask_targets_from_rois`` equal to JAX's on 0/1 ``uint8`` masks;
- ``fcn_mask_loss``, per class and class-agnostic: the loss and its
  gradient within ``TOL``;
- ``StandardRoIHead.loss`` with the FCN mask head on the same features,
  proposals and draws: every term and every parameter's gradient (and the
  features') within ``TOL`` = 2e-4 of the tensor's largest magnitude;
- ``SAMDet.loss`` (ResNet-18, a SAM of hidden 32, 128^2): every term and
  every gradient within ``TOL``, and no gradient reaches the segmentor;
- one ``Trainer.train_step`` of SAM-det on the CPU: the segmentor bitwise
  unchanged, the detector's parts all moved.

Each test prints the worst relative error it saw (``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.engine.train_state import total_loss as jax_total_loss
from rsprompter_tpu.models.detectors.samdet import SAMDet as JaxSAMDet
from rsprompter_tpu.models.roi_heads.mask_head import fcn_mask_loss as jax_fcn_mask_loss
from rsprompter_tpu.models.roi_heads.mask_head import (
    mask_targets_from_rois as jax_mask_targets_from_rois,
)
from rsprompter_tpu.models.roi_heads.standard_roi_head import (
    StandardRoIHead as JaxStandardRoIHead,
)
from rsprompter_tpu.ops.roi_align import roi_align as jax_roi_align
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.engine.train_state import build_trainer, total_loss
from rsprompter_tpu_torch.models.roi_heads.mask_head import (
    fcn_mask_loss,
    mask_targets_from_rois,
)
from rsprompter_tpu_torch.models.roi_heads.standard_roi_head import StandardRoIHead
from rsprompter_tpu_torch.ops.roi_align import roi_align
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

from test_torch_query import _random_variables
from test_torch_samdet import IMAGE, SAMDET_TINY, _init_samdet, jax_sam_config

TOL = 2e-4  # fp32 on both sides; sums run in another order
ROI_TOL = 1e-6
ROI_FP32_TOL = 1e-5
MAX_GT = 5
# the RPN and RoI samplers cut to the tiny model (the anchor train test's)
TRAIN_CFG = dict(rpn=dict(num=64, pos_fraction=0.5),
                 rpn_proposal=dict(nms_pre=100, max_per_img=24, pre_nms_total=200))
N_PROPOSALS = 24
FEAT_SIZES = (32, 16, 8, 4, 2)  # the five levels at 128^2
N_ANCHORS = 3 * sum(s * s for s in FEAT_SIZES)  # one scale, three ratios
SAMPLES = dict(num_samples=32, pos_fraction=0.25)
SAMDET_TRAIN = dict(SAMDET_TINY, train_cfg=TRAIN_CFG, **SAMPLES)


def _t(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


def jax_draws(key, b, sizes):
    """The uniforms JAX's two-stage ``loss`` draws: ``split(key)`` into the
    RPN's and the RoI sampler's keys, one key per image, three uniforms per
    sampler (``random_sample_padded``), as (3, B, n) for each of ``sizes``
    {'rpn': anchors, 'roi': G + proposals}."""
    out = {}
    for name, k in zip(("rpn", "roi"), jax.random.split(key)):
        per = [[np.asarray(jax.random.uniform(x, (sizes[name],)))
                for x in jax.random.split(kb, 3)] for kb in jax.random.split(k, b)]
        out[name] = torch.from_numpy(np.asarray(per).transpose(1, 0, 2).copy())
    return out


def check_gradients(jgrads, tgrads, tol=TOL, skip=()):
    """Every reached tensor's gradient within ``tol`` of its largest JAX
    magnitude; tensors whose JAX gradient is zero get none (or zero) in the
    port, and those whose true gradient is zero (a bias before a train-mode
    BatchNorm: JAX's reads rounding noise) are held to 1e-6 of the largest
    gradient instead, the anchor train test's rule; ``skip`` prefixes are
    checked to get no gradient at all. Returns the worst relative error and
    its tensor."""
    assert set(jgrads) == set(tgrads)
    floor = 1e-6 * max(float(g.abs().max()) for g in jgrads.values())
    worst = (0.0, "")
    for name, ref in jgrads.items():
        got = tgrads[name]
        if name.startswith(skip):
            assert got is None, name
            continue
        scale = float(ref.abs().max())
        if scale == 0.0:
            assert got is None or float(got.abs().max()) == 0.0, name
            continue
        assert got is not None, name
        err = float((got - ref).abs().max())
        if scale <= floor:
            assert err <= floor, (name, err)
            continue
        assert err <= tol * scale, (name, err / scale)
        worst = max(worst, (err / scale, name))
    return worst


def check_losses(jlosses, tlosses, names):
    assert set(jlosses) == set(tlosses) == set(names)
    worst = 0.0
    for k, ref in jlosses.items():
        np.testing.assert_allclose(tlosses[k], ref, rtol=TOL, atol=1e-6, err_msg=k)
        worst = max(worst, abs(tlosses[k] - ref) / max(abs(ref), 1e-12))
    return worst


# --- RoIAlign and the mask targets -------------------------------------------


def _ragged_rois(rng, n, b, h, w):
    """RoIs of every kind: inside, crossing each border, narrower and lower
    than a pixel, degenerate, wholly outside."""
    xy = rng.uniform(-8, max(h, w), (n, 2))
    wh = rng.uniform(0.2, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[0] = (-4.5, -2.2, 10.7, 9.1)
    boxes[1] = (w - 6.3, h - 5.9, w + 4.4, h + 3.3)
    boxes[2] = (5.2, 5.0, 5.6, 5.3)  # under a pixel each way
    boxes[3] = (7.0, 3.0, 7.0, 9.0)  # zero width
    boxes[4] = (w + 2.0, 2.0, w + 9.0, 8.0)  # outside
    idx = rng.integers(0, b, (n, 1))
    return np.concatenate([idx, boxes], 1).astype(np.float32)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("ratio", [1, 2])
def test_roi_align_matches_jax(aligned, ratio):
    rng = np.random.default_rng(ratio + 2 * aligned)
    feats = rng.standard_normal((3, 19, 23, 5)).astype(np.float32)
    rois = _ragged_rois(rng, 40, 3, 19 * 2, 23 * 2)
    args = ((7, 6), 0.5, ratio, aligned)
    ref = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), *args)
    got = roi_align(_t(feats), _t(rois), *args)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (40, 7, 6, 5)
    err32 = rel_err(got.numpy(), ref)
    with jax.enable_x64(True):
        ref64 = jax_roi_align(jnp.asarray(feats, jnp.float64), jnp.asarray(rois, jnp.float64),
                              *args)
    got64 = roi_align(_t(feats).double(), _t(rois).double(), *args)
    assert got64.dtype == torch.float64
    err64 = rel_err(got64.numpy(), ref64)
    print(f"roi_align aligned={aligned} ratio={ratio}: fp32 {err32:.3g}, float64 {err64:.3g} "
          "of the largest output")
    assert err32 <= ROI_FP32_TOL and err64 <= ROI_TOL
    assert np.abs(np.asarray(ref)[4]).max() == 0.0  # outside: all zero


def test_mask_targets_match_jax():
    """28^2 crops of each RoI's matched GT mask, uint8 masks in, held at
    0.5: equal to JAX's (which crops an fp32 copy)."""
    rng = np.random.default_rng(7)
    batch = synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT, seed=3)
    masks = batch["gt_masks"]
    assert masks.dtype == np.uint8
    rois = _ragged_rois(rng, 32, 2, IMAGE, IMAGE)
    gt_inds = rng.integers(0, MAX_GT + 1, 32)
    ref = jax_mask_targets_from_rois(jnp.asarray(masks), jnp.asarray(rois),
                                     jnp.asarray(gt_inds), (28, 28))
    got = mask_targets_from_rois(_t(masks), _t(rois), _t(gt_inds), (28, 28))
    assert got.dtype == torch.float32 and got.shape == (32, 28, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("agnostic", [False, True], ids=["per_class", "class_agnostic"])
def test_fcn_mask_loss_matches_jax(agnostic):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((12, 28, 28, 1 if agnostic else 3)).astype(np.float32) * 3
    targets = (rng.random((12, 28, 28)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 3, 12)
    valid = rng.random(12) > 0.3
    ref, jgrad = jax.jit(jax.value_and_grad(lambda x: jax_fcn_mask_loss(
        x, jnp.asarray(targets), jnp.asarray(labels), jnp.asarray(valid), agnostic)))(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = fcn_mask_loss(x, _t(targets), _t(labels), _t(valid), agnostic)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), rel=TOL)
    err = rel_err(x.grad.numpy(), jgrad)
    print(f"fcn_mask_loss agnostic={agnostic}: gradient rel err {err:.3g}")
    assert err <= TOL


def test_standard_roi_head_loss_matches_jax():
    """Sampling (GT added as proposals), the bbox head's loss, the mask
    head on the packed positive slots and the 28^2 targets: every term and
    every gradient, the features' included."""
    rng = np.random.default_rng(9)
    batch = synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT, seed=4)
    feats = [rng.standard_normal((2, s, s, 256)).astype(np.float32) for s in FEAT_SIZES]
    xy = rng.uniform(0, 100, (2, N_PROPOSALS, 2))
    props = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 60, xy.shape), IMAGE)],
                           -1).astype(np.float32)
    pvalid = rng.random((2, N_PROPOSALS)) < 0.9
    gt = [batch[k] for k in ("gt_bboxes", "gt_labels", "gt_valid", "gt_masks")]
    key = jax.random.PRNGKey(5)
    jmod = JaxStandardRoIHead(num_classes=3, **SAMPLES)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), feats, props, pvalid,
                                              *gt, key, method="loss"))
    variables = _random_variables(shapes, rng)

    def loss_fn(p, f):
        out = jmod.apply({"params": p}, f, props, pvalid, *gt, key, method="loss")
        return jax_total_loss(out), out

    (_, jlosses), (jgrads, jfeat_grads) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"], feats)

    port = StandardRoIHead(3, **SAMPLES)
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    tfeats = [_t(f).requires_grad_(True) for f in feats]
    draws = jax_draws_single(key, 2, MAX_GT + N_PROPOSALS)
    tlosses = port.loss(tfeats, _t(props), _t(pvalid), *map(_t, gt), draws)
    total_loss(tlosses).backward()
    worst_l = check_losses({k: float(v) for k, v in jlosses.items()},
                           {k: float(v.detach()) for k, v in tlosses.items()},
                           {"loss_cls", "loss_bbox", "acc", "loss_mask"})
    assert float(tlosses["loss_mask"].detach()) > 0
    worst_g = check_gradients(
        jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}),
        {n: p.grad for n, p in port.named_parameters()})
    worst_f = max(rel_err(t.grad.numpy(), j) for t, j in zip(tfeats, jfeat_grads)
                  if np.abs(np.asarray(j)).max() > 0)
    print(f"StandardRoIHead.loss: worst loss rel err {worst_l:.3g}, gradient {worst_g}, "
          f"features {worst_f:.3g}")
    assert worst_f <= TOL


def jax_draws_single(key, b, n):
    """The uniforms of one sampler given ``key`` (the RoI head's ``loss``
    called alone): one key per image, three uniforms each, (3, B, n)."""
    per = [[np.asarray(jax.random.uniform(x, (n,))) for x in jax.random.split(kb, 3)]
           for kb in jax.random.split(key, b)]
    return torch.from_numpy(np.asarray(per).transpose(1, 0, 2).copy())


# --- SAM-det -------------------------------------------------------------------


def test_samdet_loss_matches_jax():
    """The detector-only loss: RPN and bbox terms, every gradient of the
    ResNet (its frozen BN's scale and bias too), FPN, RPN and bbox head;
    the segmentor takes none (JAX's are zero, the port's absent)."""
    rng = np.random.default_rng(10)
    batch = synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "gt_masks"}
    jmod = JaxSAMDet(sam_cfg=jax_sam_config(), image_size=IMAGE, num_classes=3,
                     resnet_depth=18, train_cfg=TRAIN_CFG, **SAMPLES)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, method=_init_samdet))
    variables = _random_variables(shapes, rng)
    key = jax.random.PRNGKey(6)

    def loss_fn(p):
        out = jmod.apply({**variables, "params": p}, jbatch, key, method="loss")
        return jax_total_loss(out), out

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    port = build_detector(dict(SAMDET_TRAIN))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    port.train()
    draws = jax_draws(key, 2, {"rpn": N_ANCHORS, "roi": MAX_GT + N_PROPOSALS})
    tbatch = {k: _t(v) for k, v in batch.items() if k != "gt_masks"}
    tlosses = port.loss(tbatch, draws=draws)
    total_loss(tlosses).backward()
    worst_l = check_losses({k: float(v) for k, v in jlosses.items()},
                           {k: float(v.detach()) for k, v in tlosses.items()},
                           {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc"})
    jg = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    assert all(float(g.abs().max()) == 0.0 for n, g in jg.items() if n.startswith("segmentor"))
    tg = {n: p.grad for n, p in port.named_parameters()}
    worst_g = check_gradients(jg, tg, skip=("segmentor.",))
    for part in ("backbone.conv1", "backbone.layer4.1.bn2.weight", "neck.fpn_convs",
                 "rpn_head.rpn_reg", "roi_head.bbox_head"):
        assert any(n.startswith(part) and g is not None for n, g in tg.items()), part
    print(f"SAMDet.loss: worst loss rel err {worst_l:.3g}, gradient {worst_g}")


def test_samdet_trainer_step_trains_the_detector_alone():
    """``build_trainer(..., device='cpu')`` on SAM-det: one step moves the
    ResNet, the FPN, the RPN and the bbox head (every trained tensor
    reached), and leaves every segmentor tensor bitwise."""
    trainer = build_trainer({"model": dict(SAMDET_TRAIN), "base_lr": 1e-3, "warmup_iters": 0},
                            device="cpu", seed=0)
    model = trainer.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: _t(v) for k, v in synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT,
                                                  seed=6).items()}
    metrics = trainer.train_step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert trainer.optimizer.unreached == []
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved != n.startswith("segmentor."), n
        if n.startswith("segmentor."):
            assert p.grad is None, n
