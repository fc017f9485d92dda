"""RSPrompter-anchor predict of the torch port held against the JAX package.

A tiny model (hidden 128, two heads of 64, two layers, 128^2 input) is built
by the JAX package's ``DetInferencer`` (``attn_impl='xla'`` on the CPU, exact
softmax); its variables, drawn with numpy on ``jax.eval_shape``'s tree of
the model's init (random rel-pos tables and pos-embed among them), go to the
port through ``rsprompter_tpu_torch.utils.convert`` and
``init_detector(device='cpu')``. Both run the same seeded uint8 images, given
at the crop size so neither resizes (the JAX pipeline resizes with OpenCV,
the port with torch). fp32 on both sides.
"""

import ast
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.inference import init_detector as jax_init_detector
from rsprompter_tpu.ops.masks import finalize_masks_np as jax_finalize_masks_np
from rsprompter_tpu.ops.masks import upsample_masks as jax_upsample_masks
from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
from rsprompter_tpu_torch.ops.masks import finalize_masks, finalize_masks_np, upsample_masks
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 2e-4

TINY = dict(
    type="RSPrompterAnchor",
    bf16=False,
    num_classes=3,
    prompt_shape=(10, 5),
    image_size=128,
    select_layers=(1, 2),
    aggregator_hidden=8,
    vision_config=dict(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        global_attn_indexes=(1,), image_size=128, patch_size=16, window_size=3,
        output_channels=32,
    ),
    test_cfg=dict(
        rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
        rcnn=dict(score_thr=0.05, nms_iou_thr=0.5, max_per_img=8, nms_pre=40),
    ),
)
CROP = (128, 128)


def seeded_jax_inferencer(cfg, rng):
    """JAX's inferencer for ``cfg`` (batch 2) and variables drawn with numpy
    on ``jax.eval_shape``'s tree of its model's init
    (``test_torch_query._random_variables``). Call the inferencer inside
    ``taking(jinf, variables)``: its first call then takes them in place of
    running init, which XLA would compile as a program of its own."""
    from rsprompter_tpu.core.config import Config as JaxConfig
    from test_torch_query import _random_variables

    jinf = jax_init_detector(JaxConfig.fromdict(cfg), batch_size=2)
    h, w = cfg["crop_size"]
    batch = {"images": np.zeros((2, h, w, 3), np.uint8),
             "img_shape": np.full((2, 2), h, np.int32)}
    shapes = jax.eval_shape(lambda: jinf.model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    return jinf, _random_variables(shapes, rng)


def taking(jinf, variables):
    return mock.patch.object(type(jinf.model), "init", lambda *a, **k: variables)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(2)]
    cfg = {"model": dict(TINY), "crop_size": CROP}
    jinf, variables = seeded_jax_inferencer(cfg, rng)
    with taking(jinf, variables):
        j_preds = jinf(imgs)["predictions"]

    from rsprompter_tpu_torch.core.config import Config

    model = init_detector(
        Config.fromdict(cfg), checkpoint=jax_to_state_dict(variables), device="cpu",
    )
    t_preds = inference_detector(model, imgs)
    return j_preds, t_preds


def test_anchor_predict_matches_jax(both):
    j_preds, t_preds = both
    assert len(j_preds) == len(t_preds) == 2
    for jp, tp in zip(j_preds, t_preds):
        assert len(jp["scores"]) > 0
        np.testing.assert_allclose(tp["scores"], np.asarray(jp["scores"]), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tp["labels"], np.asarray(jp["labels"]))
        np.testing.assert_allclose(
            tp["bboxes"], np.asarray(jp["bboxes"], np.float32).reshape(-1, 4),
            atol=1e-2, rtol=TOL,  # pixel coordinates up to 128
        )
        assert tp["masks"].shape == jp["masks"].shape
        # thresholded masks: allow a few boundary pixels where the prob sits
        # within rounding of 0.5
        assert (tp["masks"] != jp["masks"]).mean() < 1e-3


def test_finalize_masks_matches_numpy():
    rng = np.random.default_rng(1)
    probs = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    args = ((256, 256), (300, 200), (200 / 300 * 256 / 200, 256 / 300))
    ref = jax_finalize_masks_np(probs, *args, thr=-1)
    np.testing.assert_array_equal(finalize_masks_np(probs, *args, thr=-1), ref)
    got = finalize_masks(torch.from_numpy(probs), *args, thr=-1).numpy()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(256, 256), (100, 70)], ids=["up", "down"])
def test_upsample_masks_matches_jax(size):
    """``jax.image.resize`` bilinear, antialiased when shrinking."""
    probs = np.random.default_rng(2).random((2, 3, 128, 96)).astype(np.float32)
    ref = np.asarray(jax_upsample_masks(jnp.asarray(probs), size))
    got = upsample_masks(torch.from_numpy(probs), size).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = ROOT / "rsprompter_tpu_torch"
    bad = []
    for path in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "rsprompter_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_port_import_loads_no_jax():
    code = (
        "import sys; import rsprompter_tpu_torch.apis.inference, "
        "rsprompter_tpu_torch.utils.convert, rsprompter_tpu_torch.engine.train_state, "
        "rsprompter_tpu_torch.utils.synthetic, "
        "rsprompter_tpu_torch.models.detectors.rsprompter_query, "
        "rsprompter_tpu_torch.models.dense_heads.mask2former_head, "
        "rsprompter_tpu_torch.models.dense_heads.pixel_decoder, "
        "rsprompter_tpu_torch.models.seg_heads.fusion_head, "
        "rsprompter_tpu_torch.models.sam.prompt_encoder, "
        "rsprompter_tpu_torch.ops.msdeform_attn, rsprompter_tpu_torch.ops.sampling, "
        "rsprompter_tpu_torch.models.detectors.samdet, "
        "rsprompter_tpu_torch.models.detectors.two_stage, "
        "rsprompter_tpu_torch.models.backbones.resnet, rsprompter_tpu_torch.models.necks.fpn, "
        "rsprompter_tpu_torch.models.roi_heads.mask_head, "
        "rsprompter_tpu_torch.models.roi_heads.standard_roi_head, "
        "rsprompter_tpu_torch.models.sam.sam, rsprompter_tpu_torch.tools.test, "
        "rsprompter_tpu_torch.ops.roi_align, rsprompter_tpu_torch.tools.train, "
        "rsprompter_tpu_torch.models.dense_heads.rpn_head, "
        "rsprompter_tpu_torch.models.task_modules.samplers; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'rsprompter_tpu')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)


def test_init_detector_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_detector({"model": dict(TINY), "crop_size": CROP})
