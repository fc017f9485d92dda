"""The encoder's ``attn_impl`` routes of the torch port against the JAX package.

fp32 on the CPU, tolerance ``TOL`` = 2e-4 (sums run in another order). The
port's CPU path runs the plain versions of its kernels; the JAX side runs its
Pallas kernels interpreted:

* ``'flash'``: the port's flash route (plain LN1, explicit window partition,
  K12' for qkv, kernel C) against JAX's ``attn_impl='flash'`` encoder, whose
  flash kernels (K10) run with ``pl.pallas_call`` patched to
  ``interpret=True``, as ``tests/test_flash_attention.py`` does;
* three heads of 64: the port's ``'fused'`` route (kernels A, B, C, which
  take any head count) against JAX's odd-head ``'fused'`` path, whose
  per-head kernel (K11) interprets itself on the CPU;
* ``qkv_headmajor_plain`` (K12') against ``fused_qkv_pair`` (K12), which
  interprets itself on the CPU.

Weights are drawn from a seed with numpy on the shapes ``jax.eval_shape``
gives and carried over by ``rsprompter_tpu_torch.utils.convert``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.models.sam.configs import SamVisionConfig as JaxVisionConfig
from rsprompter_tpu.models.sam.vision_encoder import SamVisionEncoder as JaxEncoder
from rsprompter_tpu.ops.fused_mlp import fused_qkv_pair
from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
from rsprompter_tpu_torch.apis.build import build_detector, freeze_paths_for
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

TOL = 2e-4  # fp32 on both sides; sums run in another order

FLASH_KW = dict(  # two windowed layers (the 8x8 grid pads to 9x9), one global
    hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
    global_attn_indexes=(1,), image_size=128, patch_size=16, window_size=3,
    output_channels=32,
)
ODD_KW = dict(  # three heads of 64; the 4x4 grid pads to 6x6 under window 3
    hidden_size=192, num_hidden_layers=2, num_attention_heads=3,
    global_attn_indexes=(1,), image_size=64, patch_size=16, window_size=3,
    output_channels=32,
)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _random_params(shapes, rng):
    """Kernels N(0, 1/fan_in); rel-pos tables, pos-embed, biases and norms
    N(0, 0.5)."""
    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _encoders_agree(kw, attn_impl):
    rng = np.random.default_rng(0)
    jenc = JaxEncoder(config=JaxVisionConfig(**kw), attn_impl=attn_impl)
    size = kw["image_size"]
    pixels = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), pixels))
    variables = _random_params(shapes, rng)
    j_neck, j_hidden = jax.jit(jenc.apply)(variables, pixels)

    enc = SamVisionEncoder(SamVisionConfig(**kw), attn_impl=attn_impl)
    enc.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        neck, hidden = enc(torch.from_numpy(pixels))
    assert len(hidden) == kw["num_hidden_layers"] + 1
    np.testing.assert_allclose(neck.numpy(), np.asarray(j_neck), atol=TOL, rtol=TOL)
    for i, (h, jh) in enumerate(zip(hidden, j_hidden)):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL,
                                   err_msg=f"hidden {i}")


def test_flash_encoder_matches_jax_flash(interpret_pallas):
    _encoders_agree(FLASH_KW, "flash")


def test_odd_head_encoder_matches_jax_fused():
    _encoders_agree(ODD_KW, "fused")


def test_qkv_headmajor_matches_fused_qkv_pair():
    rng = np.random.default_rng(1)
    n, s, c, heads3 = 2, 64, 128, 6
    x = rng.standard_normal((n * s, c)).astype(np.float32)
    w = (rng.standard_normal((c, heads3 * 64)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal(heads3 * 64).astype(np.float32)
    ref = jax.jit(fused_qkv_pair, static_argnums=(3, 4))(x, w, b, heads3, n)
    # JAX packs two heads per 128 lanes: (N, heads3/2, S, 128) -> (N, heads3, S, 64)
    ref = np.asarray(ref).reshape(n, heads3 // 2, s, 2, 64).transpose(0, 1, 3, 2, 4)
    got = fm.qkv_headmajor_plain(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                 torch.from_numpy(b), heads3, n)
    np.testing.assert_allclose(got.numpy(), ref.reshape(n, heads3, s, 64), atol=TOL, rtol=TOL)


def test_qkv_headmajor_backward_matches_jax():
    """dx, dw, db of ``qkv_headmajor`` against ``jax.vjp`` of ``fused_qkv_pair`` (K12, its
    backward ``_qkv_pair_bwd_vjp``), the cotangent packed two heads per 128
    lanes as JAX lays the output out."""
    rng = np.random.default_rng(2)
    n, s, c, heads3 = 2, 16, 64, 6
    x = rng.standard_normal((n * s, c)).astype(np.float32)
    w = (rng.standard_normal((c, heads3 * 64)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal(heads3 * 64).astype(np.float32)
    dy = rng.standard_normal((n, heads3, s, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: fused_qkv_pair(x, w, b, heads3, n),
                     *map(jax.numpy.asarray, (x, w, b)))
    packed = dy.reshape(n, heads3 // 2, 2, s, 64).transpose(0, 1, 3, 2, 4)
    jdx, jdw, jdb = vjp(jax.numpy.asarray(packed.reshape(n, heads3 // 2, s, 128)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = fm.qkv_headmajor(xt, wt, bt, heads3, n)
    assert y.shape == (n, heads3, s, 64)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw).T, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), atol=TOL, rtol=TOL)


def test_flash_train_step_matches_fused():
    """One train step's loss and every gradient on the 'flash' route (torch
    LN1 + partition, K12' and its backward, kernel C) against the 'fused'
    route (kernels B, C, A) at the same seeded weights, fp32 on the CPU."""
    from rsprompter_tpu_torch.engine.train_state import total_loss
    from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

    image = 64
    model = dict(
        type="RSPrompterAnchor", bf16=False, num_classes=3, prompt_shape=(10, 3),
        image_size=image, select_layers=(1, 2), aggregator_hidden=8,
        vision_config=dict(ODD_KW, patch_size=8), rpn_strides=(2, 4, 8, 16, 32),
        roi_strides=(2, 4, 8, 16), num_samples=32, pos_fraction=0.25,
        train_backbone=True, decoder_freeze=False,
        train_cfg=dict(rpn=dict(num=64, pos_fraction=0.5),
                       rpn_proposal=dict(nms_pre=100, max_per_img=24, pre_nms_total=200)),
    )
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in synthetic_batch(
        2, (image, image), 3, max_gt=5, seed=2).items()}
    runs = {}
    for impl in ("fused", "flash"):
        trainer = build_trainer({"model": dict(model, attn_impl=impl)}, device="cpu", seed=0)
        trainer.model.train()
        loss = total_loss(trainer.model.loss(batch, generator=torch.Generator().manual_seed(0)))
        loss.backward()
        runs[impl] = loss.item(), {n: p.grad for n, p in trainer.model.named_parameters()
                                   if p.grad is not None}
    (loss_f, grads_f), (loss_l, grads_l) = runs["fused"], runs["flash"]
    assert abs(loss_l - loss_f) <= 1e-4 * abs(loss_f)
    assert grads_l.keys() == grads_f.keys()
    assert all(float(grads_l[n].abs().max()) > 0 for n in grads_l if ".attn.qkv." in n)
    gmax = max(float(g.abs().max()) for g in grads_f.values())
    for n, g in grads_f.items():
        np.testing.assert_allclose(grads_l[n].numpy(), g.numpy(), rtol=1e-4, atol=1e-4 * gmax,
                                   err_msg=n)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_unknown_attn_impl_raises(attn_impl):
    cfg = dict(type="RSPrompterQuery", vision_config=ODD_KW, attn_impl=attn_impl)
    with pytest.raises(ValueError, match="'fused'.*'flash'"):
        build_detector(cfg)


@pytest.mark.parametrize("model,freeze", [
    (dict(type="SAMDet"), ["segmentor"]),
    (dict(type="SAMSegMaskRCNN"), ["backbone"]),
    (dict(type="SAMSegMask2Former"), ["backbone"]),
], ids=["samdet", "samseg_maskrcnn", "samseg_mask2former"])
def test_build_trainer_builds_the_sam_baselines(model, freeze):
    """The trainer builds SAM-det and the SAM-seg baselines on the CPU, its
    optimizer on ``freeze_paths_for``'s pair (JAX's rules): SAM-det freezes
    its SAM alone and trains its ResNet (``backbone``), the SAM-seg
    baselines freeze their SAM encoder."""
    cfg = dict(model, vision_config=ODD_KW, image_size=64)
    trainer = build_trainer({"model": cfg}, device="cpu")
    assert freeze_paths_for(cfg) == jax_freeze_paths_for(cfg) == (freeze, [])
    frozen = {n for n, _ in trainer.optimizer.frozen}
    assert frozen == {n for n, _ in trainer.model.named_parameters()
                      if n.startswith(freeze[0] + ".")} != set()
