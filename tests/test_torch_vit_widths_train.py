"""The ViT-L and ViT-H backwards of the torch port held against the JAX package.

fp32 on the CPU, where the port's wrappers run their plain versions through
their ``autograd.Function``s (on the card the same Functions launch A', B',
C' and K12'). ViT-H's 16 heads of 80 take JAX's XLA route (its Pallas
attention and LN + qkv kernels take 64 only), so at head dim 80 the port's
backwards are judged against ``jax.vjp`` of that route at the module
boundary; A' at C 1024 and 1280 runs the arithmetic A' runs at 768, which
``test_torch_backward.py`` holds against JAX's kernel body. Held here:

* B''s plain backward at head dim 80 (LN -> window partition -> qkv,
  global and windowed) against ``jax.vjp`` of JAX's ``SamLayerNorm`` ->
  ``window_partition`` -> ``_HeadMajorDense``: ``TOL`` = 2e-4 of each
  gradient's largest magnitude;
* C''s plain backward at head dim 80, with the rel-pos factors in torch
  autograd, against ``jax.vjp`` of ``attention_rel_pos(impl='xla')``
  (q, k, v and both tables; a window grid and a global one), ``TOL``;
* the hd-80 encoder (``H80``: hidden 160, two heads of 80, four layers)
  against ``jax.value_and_grad`` of JAX's ``attn_impl='fused'`` encoder
  (its Pallas MLP kernel interpreted, XLA attention): every parameter's
  gradient of a seeded cotangent on the neck and every hidden state,
  ``TOL``;
* the anchor scratch step (encoder and decoder trained) and the anchor peft
  step (LoRA on qkv, the pseudo aggregator) named ``facebook/sam-vit-huge``
  at ``H80``: every loss term (1e-4 relative) and every parameter's
  gradient against one ``jax.value_and_grad`` of JAX's ``total_loss``
  (``test_torch_train.py``'s rule: 2e-2 at the worst tensor, 1e-5 at the
  median);
* the optimizer's trained / frozen split at ViT-L and ViT-H names against
  JAX's ``freeze_paths_for`` and ``build_param_label_fn``.

JAX variables are drawn with numpy on ``jax.eval_shape``'s shapes. Each test
compiles at most one JAX ``value_and_grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_query_train as qt
from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
from rsprompter_tpu.engine.optim import TRAIN, build_param_label_fn
from rsprompter_tpu.models.sam.common import SamLayerNorm as JaxLayerNorm
from rsprompter_tpu.models.sam.configs import SamVisionConfig as JaxVisionConfig
from rsprompter_tpu.models.sam.vision_encoder import SamVisionEncoder as JaxEncoder
from rsprompter_tpu.models.sam.vision_encoder import _HeadMajorDense
from rsprompter_tpu.models.sam.vision_encoder import window_partition as jax_window_partition
from rsprompter_tpu.ops.attention import attention_rel_pos as jax_attention_rel_pos
from rsprompter_tpu_torch.apis.build import _ARCH_SELECT_LAYERS, freeze_paths_for
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa
from rsprompter_tpu_torch.ops.attention import rel_pos_factors
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict, torch_key
from test_torch_lora import PEFT, _anchor_step
from test_torch_query import _random_variables
from test_torch_train import TINY
from test_torch_vit_widths import H80

TOL = 2e-4  # fp32 on both sides; sums run in another order
HUGE = "facebook/sam-vit-huge"
# the anchor scratch config's flags (encoder and decoder trained) at H80,
# ViT-H's odd hidden states cut to its depth
SCRATCH_H80 = dict(TINY, hf_sam_pretrain_name=HUGE, vision_config=H80,
                   select_layers=tuple(i for i in _ARCH_SELECT_LAYERS["huge"]
                                       if i <= H80["num_hidden_layers"]))
# the anchor peft config's flags: the encoder frozen but for its adapters
PEFT_H80 = dict(SCRATCH_H80, train_backbone=False, decoder_freeze=True, **PEFT)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _vjp(fn, args, rng):
    """fn's output, a seeded cotangent of its shape, and the vjp of that
    cotangent, in one jitted program (an eager ``jax.vjp`` dispatches and
    compiles each operation on its own)."""
    ct = rng.standard_normal(jax.eval_shape(fn, *args).shape).astype(np.float32)

    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    out, grads = jax.jit(run)(args, ct)
    return out, ct, grads


def _assert_close(name, got, ref):
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(got.detach().double().numpy() - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("window", [0, 3])
def test_hd80_qkv_backward_matches_jax_xla(window):
    """B''s plain backward (through kernel B's Function) at two heads of 80,
    C 160, on an 8 x 7 grid (zero-padded to 9 x 9 under window 3), against
    ``jax.vjp`` of LN -> window partition -> ``_HeadMajorDense``: dx, the
    LN scale and bias, the weight and bias."""
    rng = np.random.default_rng(0)
    c, heads3, d, grid = 160, 6, 80, (8, 7)
    x = rng.standard_normal((2, *grid, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(c)).astype(np.float32)
    kernel = (rng.standard_normal((c, heads3 * d)) / np.sqrt(c)).astype(np.float32)
    bias = rng.standard_normal(heads3 * d).astype(np.float32)

    def jax_qkv(x, scale, shift, kernel, bias):
        z = JaxLayerNorm().apply({"params": {"scale": scale, "bias": shift}}, x)
        if window:
            z, _ = jax_window_partition(z, window)
        z = z.reshape(z.shape[0], -1, c)
        dense = _HeadMajorDense(heads=heads3, head_dim=d)
        return dense.apply({"params": {"kernel": kernel, "bias": bias}}, z)

    ref, dy, j_grads = _vjp(jax_qkv, (x, scale, shift, kernel, bias), rng)

    leaves = [_t(a).requires_grad_(True) for a in (x, scale, shift, kernel.T, bias)]
    out = fm.ln_qkv_headmajor(*leaves, heads3, window)
    _assert_close("qkv", out, ref)
    out.backward(_t(dy))
    for name, leaf, jg in zip(("dx", "dscale", "dshift"), leaves, j_grads):
        _assert_close(name, leaf.grad, jg)
    _assert_close("dW", leaves[3].grad.t(), j_grads[3])
    _assert_close("db", leaves[4].grad, j_grads[4])


@pytest.mark.parametrize("hw", [(3, 3), (8, 7)])
def test_hd80_attention_backward_matches_jax_xla(hw):
    """C''s plain backward (through kernel C's Function, the rel-pos
    factors in torch autograd) at two heads of 80 against ``jax.vjp`` of
    ``attention_rel_pos(impl='xla')``: dq, dk, dv and both tables' grads,
    at a window grid and a global one."""
    rng = np.random.default_rng(1)
    n_img, heads, d = 3, 2, 80
    s = hw[0] * hw[1]
    q, k, v = (rng.standard_normal((n_img, heads, s, d)).astype(np.float32) for _ in range(3))
    rel_h = (0.5 * rng.standard_normal((2 * hw[0] - 1, d))).astype(np.float32)
    rel_w = (0.5 * rng.standard_normal((2 * hw[1] - 1, d))).astype(np.float32)
    ref, dout, j_grads = _vjp(
        lambda q, k, v, rh, rw: jax_attention_rel_pos(q, k, v, hw, rh, rw, impl="xla"),
        (q, k, v, rel_h, rel_w), rng)

    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, rel_h, rel_w)]
    fh, fw = rel_pos_factors(leaves[0], leaves[3], leaves[4], hw)
    out = fa.relpos_attention(torch.cat(leaves[:3], dim=1), fh.contiguous(), fw.contiguous(), hw)
    _assert_close("out", out, ref)
    out.backward(_t(dout))
    for name, leaf, jg in zip(("dq", "dk", "dv", "drel_h", "drel_w"), leaves, j_grads):
        _assert_close(name, leaf.grad, jg)


def test_hd80_encoder_gradients_match_jax_fused():
    """The hd-80 encoder's gradients: every parameter's, for a seeded
    cotangent on the neck and every hidden state, against
    ``jax.value_and_grad`` of JAX's ``'fused'`` encoder (Pallas MLP kernel
    interpreted, XLA attention and qkv at head dim 80)."""
    rng = np.random.default_rng(2)
    jenc = JaxEncoder(config=JaxVisionConfig(**H80), attn_impl="fused")
    size = H80["image_size"]
    pixels = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), pixels))
    variables = _random_variables(shapes, rng)
    outs = jax.eval_shape(lambda v: jenc.apply(v, pixels), variables)
    cots = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), outs)

    def loss(p):
        neck, hidden = jenc.apply({**variables, "params": p}, pixels)
        return jnp.sum(neck * cots[0]) + sum(jnp.sum(h * c) for h, c in zip(hidden, cots[1]))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    j_grads = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, j_grads)})

    enc = SamVisionEncoder(SamVisionConfig(**H80), attn_impl="fused")
    enc.load_state_dict(jax_to_state_dict(variables), strict=True)
    neck, hidden = enc(_t(pixels))
    t_loss = (neck * _t(cots[0])).sum() + sum(
        (h * _t(c)).sum() for h, c in zip(hidden, cots[1]))
    t_loss.backward()
    assert float(t_loss.detach()) == pytest.approx(float(j_loss), rel=TOL)
    grads = {n: p.grad for n, p in enc.named_parameters()}
    assert set(grads) == set(j_grads)
    for name, ref in j_grads.items():
        _assert_close(name, grads[name], ref.numpy())
    assert any(n.endswith("rel_pos_h") for n in grads) and "layers.0.mlp.lin1.weight" in grads


def _check_step(case, parts):
    jl_, tl_ = case["jlosses"], case["tlosses"]
    assert set(jl_) == set(tl_)
    for k in jl_:
        np.testing.assert_allclose(tl_[k], jl_[k], rtol=1e-4, atol=1e-6, err_msg=k)
    qt._check_gradients({"jgrads": case["jgrads"], "tgrads": case["tgrads"]}, parts=parts)


def test_huge_anchor_scratch_step_matches_jax():
    """The anchor scratch step at ViT-H's name and head dim 80: every loss
    term and every parameter's gradient, encoder included, against JAX."""
    _check_step(_anchor_step(SCRATCH_H80), parts=(
        "backbone.layers.0.mlp", "backbone.layers.1.attn.rel_pos_h",
        "backbone.layers.0.attn.qkv", "neck_feature_aggregator", "point_emb"))


def test_huge_anchor_peft_step_matches_jax():
    """The anchor peft step at ViT-H's name and head dim 80 (the adapter
    folded into K12''s K on the card, K = C + 64): every loss term and
    every parameter's gradient, the frozen encoder's and the adapters'
    included, against JAX's XLA LoRA route."""
    _check_step(_anchor_step(PEFT_H80), parts=(
        "backbone.layers.0.mlp", "qkv_lora_a", "qkv_lora_b",
        "neck_feature_aggregator.channel_fusion", "point_emb"))


@pytest.mark.parametrize("arch", ["large", "huge"])
@pytest.mark.parametrize("peft", [False, True], ids=["scratch", "peft"])
def test_wide_freeze_paths_match_jax(arch, peft):
    """The scratch and peft configs at ViT-L's and ViT-H's names: the freeze
    and override paths equal JAX's ``freeze_paths_for``, and the optimizer's
    trained / frozen split on the built model (H80 widths) equals JAX's
    ``build_param_label_fn`` on JAX's parameter tree of the same config."""
    from rsprompter_tpu.apis.build import build_detector as jax_build_detector

    cfg = dict(PEFT_H80 if peft else SCRATCH_H80, hf_sam_pretrain_name=f"facebook/sam-vit-{arch}")
    freeze, override = jax_freeze_paths_for(cfg)
    assert freeze_paths_for(cfg) == (freeze, override)
    model = jax_build_detector(dict(cfg))
    img = H80["image_size"]
    batch = {"images": np.zeros((2, img, img, 3), np.uint8),
             "img_shape": np.full((2, 2), img, np.int32)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    labels = build_param_label_fn(freeze, override)(shapes["params"])
    want = {torch_key(tuple(p.key for p in path)): label == TRAIN
            for path, label in jax.tree_util.tree_flatten_with_path(labels)[0]}
    trainer = build_trainer({"model": cfg}, device="cpu", seed=0)
    trained = {n for n, _ in trainer.optimizer.trained}
    got = {n: n in trained for n, _ in trainer.model.named_parameters()}
    assert got == want
    encoder_trained = {n for n in trained if n.startswith("backbone")}
    if peft:
        assert encoder_trained == {n for n in got if "qkv_lora" in n}
    else:
        assert encoder_trained == {n for n in got if n.startswith("backbone")}
