"""LoRA and the peft configs of the torch port against the JAX package.

The peft configs (``rsprompter_{anchor,query}-nwpu-peft-512.py``) give
every encoder block a low-rank adapter on qkv (``qkv_lora_a`` (C, r),
``qkv_lora_b`` (r, 3C), scale alpha / r), read the image embeddings alone
through the pseudo feature aggregator, and train the adapters inside a
frozen encoder (the optimizer's override paths). Held here, fp32 on the
CPU (the port's CPU path runs the plain versions of its kernels; JAX runs
its Pallas kernels interpreted, as its own tests do), every adapter's
``qkv_lora_b`` drawn non-zero (at JAX's init it is zero, and an adapter
that computes could not be told from one that was dropped):

- the LoRA encoder (hidden 128, two heads of 64, two layers) on both
  ``attn_impl`` routes against JAX's ``SamVisionEncoder(lora_rank=4)`` on
  the same route: forward and every parameter's gradient, ``TOL`` = 2e-4
  of each tensor's largest magnitude;
- ``qkv_headmajor_lora`` (K12' with the adapter) against JAX's
  ``_HeadMajorDense`` with ``lora``, forward and backward;
- ``PseudoFeatureAggregator`` against JAX's, forward and gradients;
- the anchor and query peft configs at a tiny ``vision_config``: every loss
  term and every parameter's gradient against one
  ``jax.value_and_grad`` of JAX's ``total_loss`` (the rules of
  ``tests/test_torch_train.py`` and ``tests/test_torch_query_train.py``);
- ``mask_loss_resolution='low'`` against JAX's loss terms;
- the optimizer's labels against JAX's ``build_param_label_fn`` with the
  override paths, and one trainer step that moves the adapters alone in
  the encoder;
- one ``tools.train`` epoch on the anchor peft config over synthetic PNGs,
  and a resume from its checkpoint bitwise equal to the straight run.

JAX's variables are drawn with numpy on ``jax.eval_shape``'s shapes (its
model init compiles for a minute) and carried to the port through
``rsprompter_tpu_torch.utils.convert``.
"""

import functools
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_query_train as qt
from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
from rsprompter_tpu.engine.optim import TRAIN, build_param_label_fn
from rsprompter_tpu.engine.train_state import total_loss as jax_total_loss
from rsprompter_tpu.models.necks.rsfpn import PseudoFeatureAggregator as JaxPseudo
from rsprompter_tpu.models.sam.configs import SamVisionConfig as JaxVisionConfig
from rsprompter_tpu.models.sam.vision_encoder import SamVisionEncoder as JaxEncoder
from rsprompter_tpu.models.sam.vision_encoder import _HeadMajorDense
from rsprompter_tpu_torch.apis.build import build_detector, freeze_paths_for
from rsprompter_tpu_torch.engine.checkpoint import load_sam_pretrained, load_train_checkpoint
from rsprompter_tpu_torch.engine.train_state import build_trainer, total_loss
from rsprompter_tpu_torch.models.necks.rsfpn import PseudoFeatureAggregator
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.tools import train as train_tool
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict, torch_key
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch, synthetic_coco
from test_torch_query import _random_variables
from test_torch_train import TINY as ANCHOR_TINY
from test_torch_train import jax_draws as anchor_draws
from test_torch_train_loop import CLASSES, TINY_MODEL

TOL = 2e-4  # fp32 on both sides; sums run in another order
PEFT = dict(peft_config=dict(r=4, lora_alpha=8, target_modules=["qkv"]),
            aggregator_type="pseudo")
LORA_KW = dict(  # two heads of 64 (JAX's pair-packed 'fused' kernels take them)
    hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
    global_attn_indexes=(1,), image_size=128, patch_size=16, window_size=3,
    output_channels=32,
)
# the anchor peft config at the anchor train test's tiny size: encoder frozen
# but for its adapters, decoder frozen (the config's decoder_freeze)
ANCHOR_PEFT = dict(ANCHOR_TINY, train_backbone=False, decoder_freeze=True, **PEFT)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# --- the encoder and K12' with the adapter ----------------------------------


@pytest.mark.parametrize("attn_impl", ["fused", "flash"])
def test_lora_encoder_matches_jax(attn_impl, interpret_pallas):
    """Forward (neck and every hidden state) and every parameter's gradient
    of a seeded cotangent, JAX's route against the port's. JAX's encoder
    takes the exact softmax its ``build_detector`` gives an encoder that
    trains (``safe_softmax``): the adapters push the logits past its
    clamp's range, where the port's exact online softmax differs."""
    rng = np.random.default_rng(0)
    jenc = JaxEncoder(config=JaxVisionConfig(**LORA_KW), attn_impl=attn_impl,
                      lora_rank=4, lora_alpha=8.0, safe_softmax=True)
    pixels = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), pixels))
    params = _random_variables(shapes, rng)["params"]
    assert float(np.abs(params["layers_0"]["attn"]["qkv_lora_b"]).min()) > 0
    outs = jax.eval_shape(lambda p: jenc.apply({"params": p}, pixels), params)
    cots = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), outs)

    def loss(p):
        got = jenc.apply({"params": p}, pixels)
        return sum(jnp.vdot(a, c) for a, c in zip(jax.tree_util.tree_leaves(got),
                                                   jax.tree_util.tree_leaves(cots))), got

    (_, (jneck, jhidden)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    enc = SamVisionEncoder(SamVisionConfig(**LORA_KW), attn_impl, lora_rank=4, lora_alpha=8.0)
    enc.load_state_dict(jax_to_state_dict({"params": params}), strict=True)
    neck, hidden = enc(_t(pixels))
    torch.autograd.backward((neck,) + hidden,
                            [_t(c) for c in jax.tree_util.tree_leaves(cots)])
    assert len(hidden) == LORA_KW["num_hidden_layers"] + 1
    for i, (h, jh) in enumerate(zip((neck,) + hidden, (jneck,) + tuple(jhidden))):
        assert _rel_err(h.detach().numpy(), jh) <= TOL, f"output {i}"
    ref = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = {n: p.grad for n, p in enc.named_parameters()}
    assert grads.keys() == ref.keys()
    for name, g in ref.items():
        assert _rel_err(grads[name].numpy(), g.numpy()) <= TOL, name
    assert sum("lora" in n for n in ref) == 4


def test_qkv_headmajor_lora_matches_jax():
    """K12' with the adapter (the plain version, which the wrapper runs on
    the CPU) against ``_HeadMajorDense(lora=...)``: forward, and the
    gradients of x, W, b, la, lb."""
    rng = np.random.default_rng(1)
    n, s, c, heads3, r, scale = 2, 16, 128, 6, 4, 2.0
    x = rng.standard_normal((n, s, c)).astype(np.float32)
    w = (rng.standard_normal((c, heads3 * 64)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal(heads3 * 64).astype(np.float32)
    la = rng.standard_normal((c, r)).astype(np.float32)
    lb = rng.standard_normal((r, heads3 * 64)).astype(np.float32)
    dy = rng.standard_normal((n, heads3, s, 64)).astype(np.float32)
    dense = _HeadMajorDense(heads=heads3, head_dim=64)

    def f(x, w, b, la, lb):
        return dense.apply({"params": {"kernel": w, "bias": b}}, x, lora=(la, lb, scale))

    ref, vjp = jax.vjp(f, *map(jnp.asarray, (x, w, b, la, lb)))
    jdx, jdw, jdb, jdla, jdlb = vjp(jnp.asarray(dy))

    xt, wt, bt, lat, lbt = (_t(a).requires_grad_(True) for a in (x.reshape(n * s, c), w.T, b,
                                                                  la, lb))
    y = fm.qkv_headmajor_lora(xt, wt, bt, lat, lbt, scale, heads3, n)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    y.backward(_t(dy))
    for got, want in ((xt.grad, np.asarray(jdx).reshape(n * s, c)), (wt.grad, np.asarray(jdw).T),
                      (bt.grad, jdb), (lat.grad, jdla), (lbt.grad, jdlb)):
        assert _rel_err(got.numpy(), want) <= TOL


def test_pseudo_aggregator_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jmod = JaxPseudo(hidden_channels=64)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), (x,)))
    params = _random_variables(shapes, rng)["params"]
    cot = rng.standard_normal((2, 8, 8, 256)).astype(np.float32)

    def fwd_bwd(p, cot):  # one program: an eager vjp compiles each operation alone
        out, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, (x,)), p)
        return out, vjp(cot)[0]

    out, jgrads = jax.jit(fwd_bwd)(params, jnp.asarray(cot))

    mod = PseudoFeatureAggregator(32, 64, 256)
    mod.load_state_dict(jax_to_state_dict({"params": params}), strict=True)
    got = mod((_t(x),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=TOL, rtol=TOL)
    got.backward(_t(cot))
    ref = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    for name, p in mod.named_parameters():
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= TOL, name


# --- the peft configs' train steps against JAX -------------------------------


def _anchor_step(model_cfg, seed=0, grads=True):
    """One JAX value_and_grad of ``total_loss`` and the port's loss and
    backward on the same variables, batch and sampler draws (``grads=False``:
    the loss terms alone, which compile in half the time)."""
    rng = np.random.default_rng(seed)
    batch = synthetic_batch(2, (64, 64), model_cfg["num_classes"], max_gt=5, seed=1)
    batch["gt_masks"] = batch["gt_masks"].astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jax_build_detector(dict(model_cfg))
    key = jax.random.PRNGKey(3)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, key, method="loss"))
    variables = _random_variables(shapes, rng)

    def loss_fn(p):
        out, _ = model.apply({**variables, "params": p}, jbatch, key, method="loss",
                             mutable=["batch_stats"])
        return jax_total_loss(out), out

    if grads:
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    else:
        jlosses, jgrads = jax.jit(lambda p: loss_fn(p)[1])(variables["params"]), {}
    tmodel = build_detector(dict(model_cfg))
    tmodel.load_state_dict(jax_to_state_dict(variables), strict=True)
    tmodel.train()
    tlosses = tmodel.loss({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                          draws=anchor_draws(key, 2, 5))
    if grads:
        total_loss(tlosses).backward()
    return dict(
        shapes=shapes, state=jax_to_state_dict(variables), draws=anchor_draws(key, 2, 5),
        batch={k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        jlosses={k: float(v) for k, v in jlosses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        jgrads=jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
        if grads else {},
        tgrads={n: p.grad for n, p in tmodel.named_parameters()},
    )


@pytest.fixture(scope="module")
def anchor_peft():
    return _anchor_step(ANCHOR_PEFT)


def test_anchor_peft_losses_and_gradients_match_jax(anchor_peft):
    """Every loss term (1e-4 relative) and every parameter's gradient (the
    anchor train test's rule: 2e-2 at worst, 1e-5 at the median tensor),
    the frozen encoder's and the adapters' included."""
    jl_, tl_ = anchor_peft["jlosses"], anchor_peft["tlosses"]
    assert set(jl_) == set(tl_)
    for k in jl_:
        np.testing.assert_allclose(tl_[k], jl_[k], rtol=1e-4, atol=1e-6, err_msg=k)
    qt._check_gradients({"jgrads": anchor_peft["jgrads"], "tgrads": anchor_peft["tgrads"]},
                        parts=("backbone.layers.0.mlp", "qkv_lora_a", "qkv_lora_b",
                               "neck_feature_aggregator.channel_fusion", "point_emb"))


def test_anchor_peft_labels_match_jax(anchor_peft):
    """The optimizer's trained / frozen split on the anchor peft model
    against JAX's ``build_param_label_fn`` with ``freeze_paths_for``'s pair:
    the adapters train inside the frozen encoder."""
    freeze, override = jax_freeze_paths_for(ANCHOR_PEFT)
    assert (freeze, override) == (["backbone", "shared_image_embedding", "mask_decoder",
                                   "no_mask_embed"], ["lora_a", "lora_b"])
    assert freeze_paths_for(ANCHOR_PEFT) == (freeze, override)
    labels = build_param_label_fn(freeze, override)(anchor_peft["shapes"]["params"])
    want = {}
    for path, label in jax.tree_util.tree_flatten_with_path(labels)[0]:
        want[torch_key(tuple(p.key for p in path))] = label == TRAIN
    trainer = build_trainer({"model": ANCHOR_PEFT}, device="cpu", seed=0)
    trained = {n for n, _ in trainer.optimizer.trained}
    got = {n: n in trained for n, _ in trainer.model.named_parameters()}
    assert got == want
    assert {n for n in trained if n.startswith("backbone")} == {
        n for n in got if "qkv_lora" in n}


def test_low_res_mask_loss_matches_jax():
    """``mask_loss_resolution='low'``: the targets resized to SAM's mask size
    (antialiased bilinear, as ``jax.image.resize`` downsamples), held at 0.5,
    the CE there; every loss term against JAX's (1e-4 relative), and the
    mask term further from the full-resolution one than that tolerance."""
    case = _anchor_step(dict(ANCHOR_TINY, mask_loss_resolution="low"), seed=4, grads=False)
    assert set(case["jlosses"]) == set(case["tlosses"])
    for k, v in case["jlosses"].items():
        np.testing.assert_allclose(case["tlosses"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    model = build_detector(dict(ANCHOR_TINY))
    model.load_state_dict(case["state"], strict=True)
    model.train()
    with torch.no_grad():
        full = model.loss(case["batch"], draws=case["draws"])
    low = case["tlosses"]["loss_mask"]
    assert abs(float(full["loss_mask"]) - low) > 2e-4 * low


def test_query_peft_step_matches_jax(monkeypatch):
    """The query train test's step (35 loss terms, matches, selected points,
    every gradient) on the query peft config at its tiny size."""
    monkeypatch.setattr(qt, "TINY", dict(qt.TINY, train_backbone=False, **PEFT))
    case = qt._run_case()
    qt._check_losses(case)
    qt._check_matches(case)
    qt._check_points(case)
    qt._check_gradients(case, parts=qt.GRAD_PARTS + ("qkv_lora_a", "qkv_lora_b",
                                                     "channel_fusion"))


# --- entry points ------------------------------------------------------------


@pytest.mark.parametrize("config,attn_impl", [
    ("rsprompter_anchor-nwpu-peft-512.py", "fused"),
    ("rsprompter_query-nwpu-peft-512.py", "fused"),
    ("rsprompter_query-nwpu-peft-512.py", "flash"),
])
def test_peft_configs_build(config, attn_impl):
    """Both shipped peft configs build at ViT-B 512² (r 16, alpha 32, the
    pseudo aggregator), and match JAX's freeze pair."""
    from rsprompter_tpu_torch.core.config import Config

    cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "rsprompter", config))
    model_cfg = dict(cfg["model"], attn_impl=attn_impl)
    model = build_detector(model_cfg)
    attn = model.backbone.layers[0].attn
    assert attn.qkv_lora_a.shape == (768, 16) and attn.qkv_lora_b.shape == (16, 2304)
    assert attn.lora_scale == 2.0 and not model.freeze_backbone
    assert type(model.neck_feature_aggregator).__name__ == "PseudoFeatureAggregator"
    assert model.backbone.config.image_size == 512
    assert freeze_paths_for(model_cfg) == tuple(jax_freeze_paths_for(model_cfg))


def test_trainer_moves_only_the_adapters_in_the_encoder():
    """A CPU step of the anchor peft trainer: the adapters (given non-zero
    ``qkv_lora_b``) and the heads move, every other encoder tensor and the
    frozen decoder stay bitwise; the frozen weights still get gradients
    (the freeze is the optimizer's, not ``no_grad``); the adapters are
    missing from a SAM file and keep their values."""
    trainer = build_trainer({"model": dict(ANCHOR_PEFT), "base_lr": 1e-3, "warmup_iters": 0},
                            device="cpu", seed=0)
    model = trainer.model
    sd = {"vision_encoder." + n[len("backbone."):]: p.detach().clone()
          for n, p in model.named_parameters() if n.startswith("backbone.") and "lora" not in n}
    report = load_sam_pretrained(model, sd, "RSPrompterAnchor", verbose=False)
    assert report["backbone"] == dict(used=len(sd), missing=4)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("qkv_lora_b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in synthetic_batch(
        2, (64, 64), 3, max_gt=5, seed=2).items()}
    metrics = trainer.step(batch, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    for name, p in model.named_parameters():
        changed = not torch.equal(p, before[name])
        if "qkv_lora" in name or name.startswith(("rpn_head", "neck_feature")):
            assert changed, name
        elif name.startswith("backbone") or "mask_decoder" in name:
            assert not changed, name
    assert model.backbone.layers[0].mlp.lin1.weight.grad is not None


def test_train_tool_epoch_and_bitwise_resume(tmp_path):
    """``tools.train`` on the anchor peft config (tiny) over synthetic PNGs:
    three epochs of one step straight, then a fresh run resumed from the
    step-2 checkpoint; the adapters, every other tensor and the AdamW
    moments (the adapters' among them) equal bitwise."""
    coco = synthetic_coco(str(tmp_path / "coco"), CLASSES, ((64, 80), (70, 64)), cv2.imwrite,
                          seed=1)
    ds = dict(type="NWPUInsSegDataset", data_root=coco, ann_file="ann.json",
              data_prefix=dict(img="imgs"), metainfo=dict(classes=CLASSES))
    model = dict(TINY_MODEL, train_backbone=False, decoder_freeze=True, **PEFT)
    body = dict(crop_size=(64, 64), max_gt=8, base_lr=1e-3, warmup_iters=2, seed=3,
                log_interval=1, ckpt_interval=1, val_interval=100, max_epochs=3)
    cfg = tmp_path / "peft_train.py"
    cfg.write_text(f"model = {model!r}\n" + "".join(f"{k} = {v!r}\n" for k, v in body.items())
                   + f"train_dataloader = dict(batch_size=2, dataset=dict({ds!r}, indices=2))\n")
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    train_tool.main([str(cfg), "--work-dir", straight, "--device", "cpu"])
    shutil.copytree(os.path.join(straight, "ckpts", "step_2"),
                    os.path.join(split, "ckpts", "step_2"))
    runner = train_tool.main([str(cfg), "--work-dir", split, "--device", "cpu", "--resume"])
    assert runner.trainer.iter == 3
    a = load_train_checkpoint(os.path.join(straight, "ckpts", "step_3"))
    b = load_train_checkpoint(os.path.join(split, "ckpts", "step_3"))
    first = load_train_checkpoint(os.path.join(straight, "ckpts", "step_1"))
    assert a["model"].keys() == b["model"].keys()
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    lora = [n for n in a["model"] if "qkv_lora_a" in n]
    assert len(lora) == 2 and all(not torch.equal(a["model"][n], first["model"][n])
                                  for n in lora)
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert len(sa) == len(runner.trainer.optimizer.trained)
