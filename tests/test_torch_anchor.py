"""RSPrompter-anchor predict of the torch port held against the JAX package.

A tiny model (hidden 128, two heads of 64, two layers, 128^2 input) is built
by the JAX package's ``DetInferencer`` (``attn_impl='xla'`` on the CPU, exact
softmax); its variables, with random rel-pos tables and pos-embed, go to the
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


def _randomize(params, rng):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            out[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.5
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(2)]
    cfg = {"model": dict(TINY), "crop_size": CROP}
    from rsprompter_tpu.core.config import Config as JaxConfig

    jinf = jax_init_detector(JaxConfig.fromdict(cfg), batch_size=2)
    jinf(imgs[:1])  # initialise the variables
    variables = jax.tree_util.tree_map(np.asarray, jinf._variables)
    variables["params"] = _randomize(variables["params"], rng)
    stats = variables["batch_stats"]
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) + 0.5).astype(np.float32), stats
    )
    jinf._variables = jax.tree_util.tree_map(jnp.asarray, variables)
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
        "rsprompter_tpu_torch.utils.synthetic; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'rsprompter_tpu')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT, timeout=120)


def test_init_detector_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_detector({"model": dict(TINY), "crop_size": CROP})
