"""``mode='tensor'`` of the five detectors held against JAX's ``tensor``.

The reference's three-mode ``forward(batch, mode)`` (``mmdet/models/
detectors/base.py:59-99``) returns, in ``'tensor'`` mode, the raw outputs
without decode, threshold or postprocess; JAX's detectors give them as
``method='tensor'`` (``rsprompter_anchor.py:211``, ``rsprompter_query.py:180``,
``samdet.py:148``, ``two_stage.py:176``; the RoI heads'
``prompt_roi_head.py:190``, ``standard_roi_head.py:171``). Each tiny
detector of the port's predict tests (128^2 input, encoder of two layers)
has its JAX variables drawn with numpy on ``jax.eval_shape``'s shapes and
carried to the port; the same batch goes through JAX's ``tensor`` and the
port's ``forward(batch, mode='tensor')``, and the outputs are held leaf by
leaf, in JAX's tuple order, to 2e-4 (fp32 on both sides, sums in another
order). The proposals between the RPN and the RoI head come out of NMS and
must be the same on both sides for the RoI outputs to agree. The query
families run two decoder layers (JAX's ``num_decoder_layers``; the port's
head takes the same count) in place of six: the same code on each layer,
half the compile time. The variables' shapes come from tracing ``init``
through ``tensor`` itself, which reaches every parameter that ``predict``
does; SAM-det's ``tensor`` is its detector half, and its segmentor, which
``tensor`` never runs, keeps the port's own weights.

Also: ``forward`` dispatches ``'loss'`` (with its draws) and ``'predict'``
to the detector's methods and refuses another mode.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.models.detectors.samdet import SAMDet as JaxSAMDet
from rsprompter_tpu_torch.apis.build import build_detector, init_random_weights
from rsprompter_tpu_torch.models.detectors import rsprompter_query as port_query
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_anchor import TINY as ANCHOR_TINY
from test_torch_query import TINY as QUERY_TINY
from test_torch_query import _random_variables
from test_torch_samdet import IMAGE, SAMDET_TINY, TEST_CFG, _images
from test_torch_samdet import jax_sam_config
from test_torch_samseg import MASK2FORMER_TINY, MASKRCNN_TINY

TOL = 2e-4
# JAX's references compile without LLVM's optimisations: a third less compile
# time, outputs equal to the default compile's within 2e-7
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
DECODER_LAYERS = 2  # the query families' (six in their configs)
N_DECODER_CALLS = DECODER_LAYERS + 1  # one head call before each layer, one after
CONFIGS = {"anchor": ANCHOR_TINY, "query": QUERY_TINY, "maskrcnn": MASKRCNN_TINY,
           "mask2former": MASK2FORMER_TINY}


def _build(name: str, seed: int):
    """(JAX module, its variables, the port's detector on them, the batch)."""
    batch = dict(images=_images(seed), img_shape=np.array([[IMAGE, IMAGE], [100, 120]], np.int32))
    head = port_query.Mask2FormerHead
    if name == "samdet":
        jmod = JaxSAMDet(sam_cfg=jax_sam_config(), image_size=IMAGE, num_classes=3,
                         resnet_depth=18, test_cfg=TEST_CFG)
        cfg = SAMDET_TINY
    else:
        jmod, cfg = jax_build_detector(dict(CONFIGS[name])), CONFIGS[name]
    if name in ("query", "mask2former"):
        jmod = jmod.clone(num_decoder_layers=DECODER_LAYERS)
        head = functools.partial(head, num_decoder_layers=DECODER_LAYERS)
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0)}, batch,
                                              method="tensor"))
    variables = _random_variables(shapes, np.random.default_rng(seed))
    with mock.patch.object(port_query, "Mask2FormerHead", head):
        port = build_detector(dict(cfg))
    missing, unexpected = port.load_state_dict(jax_to_state_dict(variables), strict=False)
    # SAM-det's tensor is its detector half: its segmentor keeps the port's own init
    assert not unexpected and all(k.startswith("segmentor.") for k in missing)
    assert bool(missing) == (name == "samdet")
    return jmod, variables, port.eval(), batch


def _shapes(tree):
    return [tuple(x.shape) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", ["anchor", "query", "samdet", "maskrcnn", "mask2former"])
def test_tensor_mode_matches_jax(name):
    jmod, variables, port, batch = _build(name, 11)
    ref = jax.jit(lambda v, b: jmod.apply(v, b, method="tensor")).lower(
        variables, batch).compile(compiler_options=FAST_COMPILE)(variables, batch)
    got = port({k: torch.from_numpy(v) for k, v in batch.items()}, mode="tensor")
    got_np = jax.tree_util.tree_map(lambda t: t.float().numpy(), got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, ref))
    assert _shapes(got_np) == _shapes(ref)
    for i, (g, r) in enumerate(zip(jax.tree_util.tree_leaves(got_np),
                                   jax.tree_util.tree_leaves(ref))):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL, rtol=TOL, err_msg=f"leaf {i}")
    if name in ("query", "mask2former"):
        cls_list, mask_list = got
        assert len(cls_list) == len(mask_list) == N_DECODER_CALLS
        assert cls_list[-1].shape == (2, 6, 4)
        return
    levels = 5  # the RPN's: per-level scores (B, h, w, A) and deltas (B, h, w, 4A)
    assert all(s.shape[-1] * 4 == d.shape[-1] for s, d in zip(got[0], got[1]))
    assert len(got[0]) == len(got[1]) == levels
    cls_logits, deltas = got[2], got[3]
    n = cls_logits.shape[1]
    assert cls_logits.shape == (2, n, 4) and deltas.shape == (2, n, 12)
    if name == "anchor":  # SAM's logits and IoU on the first num_mask_slots proposals
        assert got[4].ndim == 4 and got[5].shape == got[4].shape[:2]
    elif name == "maskrcnn":  # per-class FCN logits on the first min(N, 100) proposals
        assert got[4].shape[1:] == (min(n, 100), 28, 28, 3)
    else:
        assert len(got) == 4  # SAM-det: the detector half alone


def test_forward_dispatches_each_mode():
    port = build_detector(dict(MASKRCNN_TINY))
    init_random_weights(port, 12)
    port.eval()
    tbatch = {"images": torch.from_numpy(_images(12)),
              "img_shape": torch.tensor([[IMAGE, IMAGE], [100, 120]], dtype=torch.int32)}
    dets, probs = port(tbatch, mode="predict")
    ref_dets, ref_probs = port.predict(tbatch)
    assert torch.equal(dets.boxes, ref_dets.boxes) and torch.equal(probs, ref_probs)
    b, g = 2, 3
    tbatch.update(gt_bboxes=torch.tensor([[[10.0, 12, 60, 70]] * g] * b),
                  gt_labels=torch.zeros(b, g, dtype=torch.long),
                  gt_valid=torch.tensor([[True, False, False]] * b),
                  gt_masks=torch.zeros(b, g, IMAGE, IMAGE))
    port.train()
    losses = port(tbatch, mode="loss", generator=torch.Generator().manual_seed(0))
    assert {"loss_rpn_cls", "loss_cls", "loss_mask"} <= set(losses)
    with pytest.raises(ValueError, match="mode='bogus'"):
        port(tbatch, mode="bogus")
    with pytest.raises(TypeError):
        port(tbatch, mode="predict", generator=None)
