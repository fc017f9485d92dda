"""Flip test-time augmentation of the port (``rsprompter_tpu_torch/models/tta.py``)
against the JAX package's ``models/tta.py``.

- ``hflip_batch`` equals JAX's on images whose valid widths differ (the
  padding stays on the right).
- The merged predict of a tiny RSPrompter-anchor (hidden 32, two layers,
  64^2, batch 2, one image narrower than the canvas) equals JAX's jitted
  ``make_tta_predict`` on the same weights: JAX's variables drawn with numpy
  on ``jax.eval_shape``'s shapes and converted (``utils.convert``); boxes
  and scores to 2e-4, labels and the kept slots exactly, the uint8 mask
  probabilities within one level. It holds more detections than either
  view's alone would give after the merge (both views contribute).
- With a stub detector the merge's mask mapping is held on its own:
  full-frame masks mirror and shift back exactly as JAX's do; in 'paste'
  mode (SAM-seg Mask R-CNN's RoI maps) the port mirrors each map without
  the shift, while JAX shifts the map inside its box as if it covered the
  frame: a reference fault, recorded here.
- ``tools.test`` refuses ``--tta`` beside ``--oracle``, as JAX's does;
  ``tta_settings`` reads ``model.test_cfg.rcnn`` as JAX's tool does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.models.roi_heads.bbox_head import DetResult as JaxDetResult
from rsprompter_tpu.models.tta import hflip_batch as jax_hflip_batch
from rsprompter_tpu.models.tta import make_tta_predict as jax_make_tta_predict
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.models.roi_heads.bbox_head import DetResult
from rsprompter_tpu_torch.models.tta import hflip_batch, make_tta_predict, tta_settings
from rsprompter_tpu_torch.ops.masks import quantize_probs_u8
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

TOL = 2e-4
SIZE = 64
PAD = 116  # round(0.456 * 255), the pad level of the middle channel
TINY = dict(
    type="RSPrompterAnchor", bf16=False, num_classes=3, prompt_shape=(10, 3),
    image_size=SIZE, select_layers=(1, 2), aggregator_hidden=8,
    vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       global_attn_indexes=(1,), image_size=SIZE, patch_size=8, window_size=4,
                       output_channels=32),
    rpn_strides=(2, 4, 8, 16, 32), roi_strides=(2, 4, 8, 16),
    test_cfg=dict(rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
                  rcnn=dict(score_thr=0.05, nms_iou_thr=0.5, max_per_img=8, nms_pre=40)),
)


def _batch(seed, widths=(48, SIZE), heights=(SIZE, 56)):
    rng = np.random.default_rng(seed)
    images = np.full((len(widths), SIZE, SIZE, 3), PAD, np.uint8)
    for i, (h, w) in enumerate(zip(heights, widths)):
        coarse = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        images[i, :h, :w] = np.clip(field + rng.normal(0, 8, field.shape), 0, 255)
    return {"images": images, "img_shape": np.stack([heights, widths], 1).astype(np.int32)}


def _draw(path, shape, rng):
    """Seeded values a leaf, at scales that keep the tiny model's
    activations ordinary."""
    name = str(getattr(path[-1], "key", path[-1]))
    z = rng.standard_normal(shape.shape).astype(np.float32)
    if name == "var":
        return np.abs(z) + 0.5
    if name in ("mean", "bias"):
        return 0.1 * z
    if name == "scale":
        return 1 + 0.1 * z
    if name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
        return 0.5 * z
    return z / np.sqrt(max(int(np.prod(shape.shape[:-1])), 1))


def test_hflip_batch_matches_jax():
    b = _batch(0, widths=(40, 64, 1), heights=(64, 30, 64))
    b["images"][..., 1] = np.arange(SIZE, dtype=np.uint8)[None, None, :]  # columns told apart
    ref = jax_hflip_batch({k: jnp.asarray(v) for k, v in b.items()})
    got = hflip_batch({k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_array_equal(got["images"].numpy(), np.asarray(ref["images"]))
    # image 0: its 40 valid columns mirrored, the padding's after them
    assert got["images"][0, 0, :40, 1].tolist() == list(range(39, -1, -1))
    assert got["images"][0, 0, 40:, 1].tolist() == list(range(63, 39, -1))


def test_tta_predict_matches_jax():
    """The merged predict against JAX's (one test: its JAX compile runs
    once); some kept detections come from the mirrored view, boxes the plain
    predict does not have."""
    model = jax_build_detector(dict(TINY))
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, method="predict"))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(lambda p, s: _draw(p, s, rng), shapes)
    settings = tta_settings(Config.fromdict({"model": TINY}))
    assert settings == dict(iou_thr=0.5, max_per_img=8)
    jdets, jprobs = jax.jit(jax_make_tta_predict(model, **settings))(variables, jbatch)
    jdets, jprobs = jax.tree_util.tree_map(np.asarray, jdets), np.asarray(jprobs)
    port = build_detector(dict(TINY))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    port.eval()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tdets, tprobs = make_tta_predict(port, **settings)(tbatch)

    assert tdets.boxes.shape == jdets.boxes.shape == (2, 8, 4)
    np.testing.assert_array_equal(tdets.valid.numpy(), jdets.valid)
    valid = jdets.valid
    assert valid.sum(1).min() > 0
    np.testing.assert_array_equal(tdets.labels.numpy()[valid], jdets.labels[valid])
    np.testing.assert_allclose(tdets.scores.numpy()[valid], jdets.scores[valid], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tdets.boxes.numpy()[valid], jdets.boxes[valid], atol=1e-2,
                               rtol=TOL)  # pixel coordinates up to 64
    ours = quantize_probs_u8(tprobs).numpy()[valid].astype(int)
    ref = np.round(jprobs[valid] * 255).astype(int)
    assert tprobs.shape == jprobs.shape
    assert np.abs(ours - ref).max() <= 1

    plain = port.predict(tbatch)[0]
    found_new = False
    for i in range(2):
        kept = tdets.boxes[i][tdets.valid[i]]
        base = plain.boxes[i][plain.valid[i]]
        d = (kept[:, None] - base[None]).abs().amax(-1).amin(-1)
        found_new |= bool((d > 1e-3).any())
    assert found_new


class _Stub(torch.nn.Module):
    """A detector whose predict ignores the pixels: one box a image and an
    asymmetric mask raster, so the merge's mapping of the mirrored view is
    all there is to see."""

    def __init__(self, mask_mode, raster):
        super().__init__()
        self.mask_mode = mask_mode
        self.raster = raster  # (s, s)

    def predict(self, batch):
        b = batch["images"].shape[0]
        boxes = torch.tensor([[4.0, 6.0, 20.0, 30.0]]).expand(b, 1, 4)
        dets = DetResult(boxes, torch.full((b, 1), 0.9), torch.zeros(b, 1, dtype=torch.long),
                         torch.ones(b, 1, dtype=torch.bool))
        return dets, self.raster.expand(b, 1, *self.raster.shape)


class _JaxStub:
    def __init__(self, raster):
        self.raster = jnp.asarray(raster)

    def apply(self, variables, batch, method):
        b = batch["images"].shape[0]
        boxes = jnp.broadcast_to(jnp.array([[4.0, 6.0, 20.0, 30.0]]), (b, 1, 4))
        dets = JaxDetResult(boxes, jnp.full((b, 1), 0.9), jnp.zeros((b, 1), jnp.int32),
                            jnp.ones((b, 1), bool))
        return dets, jnp.broadcast_to(self.raster, (b, 1, *self.raster.shape))


@pytest.mark.parametrize("mode,s", [("fullframe", 16), ("paste", 28)])
def test_mirrored_masks(mode, s):
    raster = np.random.default_rng(s).uniform(0, 1, (s, s)).astype(np.float32)
    batch = _batch(2, widths=(40, 64, 13), heights=(64, 64, 64))
    tdets, tprobs = make_tta_predict(_Stub(mode, torch.from_numpy(raster)), iou_thr=0.5,
                                     max_per_img=4)({k: torch.from_numpy(v)
                                                     for k, v in batch.items()})
    jdets, jprobs = jax_make_tta_predict(_JaxStub(raster), iou_thr=0.5, max_per_img=4)(
        None, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(tdets.boxes.numpy(), np.asarray(jdets.boxes), atol=1e-6)
    np.testing.assert_array_equal(tdets.valid.numpy(), np.asarray(jdets.valid))
    jprobs = np.asarray(jprobs)
    for i, wv in enumerate((40, 64, 13)):
        # the mirrored view's box: [wv - 20, 6, wv - 4, 30], second after the tie
        k = int(np.flatnonzero(np.isclose(tdets.boxes[i, :, 0].numpy(), wv - 20))[0])
        if mode == "fullframe":
            np.testing.assert_array_equal(tprobs[i, k].numpy(), jprobs[i, k])
        else:
            np.testing.assert_array_equal(tprobs[i, k].numpy(), raster[:, ::-1])
            shift = int(np.round(wv / (SIZE / s))) - s
            jax_roll = np.roll(raster[:, ::-1], shift, axis=-1)
            np.testing.assert_array_equal(jprobs[i, k], jax_roll)
            if shift % s:  # JAX moves the map inside its box: the reference fault
                assert not np.array_equal(jprobs[i, k], raster[:, ::-1])


def test_tta_with_oracle_refused(capsys):
    from rsprompter_tpu_torch.tools import test as tool

    with pytest.raises(SystemExit):
        tool.parse_args(["cfg.py", "--tta", "--oracle"])
    assert "mutually exclusive" in capsys.readouterr().err
    args = tool.parse_args(["cfg.py", "--tta"])
    assert args.tta and not args.oracle


def test_tta_settings_defaults():
    assert tta_settings(Config.fromdict({"model": {"type": "RSPrompterQuery"}})) == dict(
        iou_thr=0.5, max_per_img=100)
