"""The port's resize against ``cv2.resize`` INTER_LINEAR, and predict on
images that need resizing against the JAX inferencer.

The JAX pipelines read images as float32, resize them with OpenCV and round
to uint8; the port rebuilds OpenCV's float scheme in torch
(``rsprompter_tpu_torch.ops.image``). After rounding, at most 1e-3 of the
pixels may differ, by one level (a few in 10^6 do: OpenCV's vector code
orders its float sums differently, a few ulps). Run as a script it prints
those shares, beside a torch bilinear interpolation's and OpenCV's own
uint8 path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.inference import init_detector as jax_init_detector
from rsprompter_tpu_torch.apis.inference import _target_size, inference_detector, init_detector
from rsprompter_tpu_torch.ops.image import resize_bilinear_cv2
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
from test_torch_anchor import CROP, TINY, TOL, _randomize

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("hw,crop", [
    ((800, 1000), (1024, 1024)), ((960, 860), (1024, 1024)), ((958, 808), (1024, 1024)),
    ((1500, 1200), (1024, 1024)), ((2048, 1024), (1024, 512)), ((33, 47), (128, 128)),
])
def test_resize_matches_cv2(hw, crop):
    """Keep-ratio resizes into the crop: upscales, a downscale and an exact
    halving (OpenCV's 2x2 area path), three channels of seeded noise."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    nh, nw = _target_size(hw[0], hw[1], crop)
    ref_f = cv2.resize(img.astype(np.float32), (nw, nh), interpolation=cv2.INTER_LINEAR)
    got_f = resize_bilinear_cv2(torch.from_numpy(img), (nh, nw)).numpy()
    assert got_f.shape == ref_f.shape
    assert np.abs(got_f - ref_f).max() <= 1e-4  # a few float32 ulps at 255
    ref = np.clip(np.round(ref_f), 0, 255).astype(np.uint8)
    got = np.clip(np.round(got_f), 0, 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - ref.astype(int))
    share = (diff > 0).mean()
    assert diff.max() <= 1 and share <= 1e-3, f"{share:.3e} of pixels differ"


def test_predict_with_resize_matches_jax():
    """Images of 100x150 and 90x70 are resized into the 128^2 crop by both
    pipelines (OpenCV in JAX's, the port's own resize) and padded; the
    detections agree as in ``test_torch_anchor``."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((100, 150), (90, 70))]
    cfg = {"model": dict(TINY), "crop_size": CROP}
    from rsprompter_tpu.core.config import Config as JaxConfig

    jinf = jax_init_detector(JaxConfig.fromdict(cfg), batch_size=2)
    jinf(imgs[:1])  # initialise the variables
    variables = jax.tree_util.tree_map(np.asarray, jinf._variables)
    variables["params"] = _randomize(variables["params"], rng)
    jinf._variables = jax.tree_util.tree_map(jnp.asarray, variables)
    j_preds = jinf(imgs)["predictions"]

    from rsprompter_tpu_torch.core.config import Config

    model = init_detector(Config.fromdict(cfg), checkpoint=jax_to_state_dict(variables),
                          device="cpu")
    t_preds = inference_detector(model, imgs)
    for jp, tp, img in zip(j_preds, t_preds, imgs):
        assert len(jp["scores"]) > 0
        np.testing.assert_allclose(tp["scores"], np.asarray(jp["scores"]), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tp["labels"], np.asarray(jp["labels"]))
        np.testing.assert_allclose(
            tp["bboxes"], np.asarray(jp["bboxes"], np.float32).reshape(-1, 4),
            atol=1e-2, rtol=TOL,
        )
        assert tp["masks"].shape == jp["masks"].shape == (len(tp["scores"]),) + img.shape[:2]
        assert (tp["masks"] != jp["masks"]).mean() < 1e-3


if __name__ == "__main__":
    # Share of pixels that differ by a level from the JAX pipeline's resize
    # (cv2 INTER_LINEAR on float32, rounded), for the port's resize, for a
    # torch bilinear interpolation, and for cv2's own uint8 path.
    import torch.nn.functional as F

    for hw in ((800, 1000), (960, 860), (958, 808)):
        img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
        nh, nw = _target_size(hw[0], hw[1], (1024, 1024))
        ref = np.clip(np.round(cv2.resize(img.astype(np.float32), (nw, nh),
                                          interpolation=cv2.INTER_LINEAR)), 0, 255)
        port = resize_bilinear_cv2(torch.from_numpy(img), (nh, nw)).round().clamp(0, 255)
        interp = F.interpolate(torch.from_numpy(img).float().permute(2, 0, 1)[None],
                               size=(nh, nw), mode="bilinear", align_corners=False)
        interp = interp[0].permute(1, 2, 0).round().clamp(0, 255)
        u8 = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        shares = {name: float((np.asarray(x, np.float64) != ref).mean())
                  for name, x in (("port", port.numpy()), ("F.interpolate", interp.numpy()),
                                  ("cv2 uint8", u8))}
        print(f"{hw} -> {(nh, nw)} (OpenCV {cv2.__version__}): {shares}")
