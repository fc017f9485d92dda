"""The port's RSPrompter-anchor train step held against the JAX package.

A tiny model (encoder hidden 32, two heads of 16, two layers: one windowed
over a 9x9 padded grid, one global; decoder and neck width 32; 64^2 input)
has its variables drawn with numpy on ``jax.eval_shape``'s tree of the JAX
model's init (``test_torch_query._random_variables``: kernels N(0, 1/fan_in),
variances positive, every other leaf, the rel-pos tables and pos-embed
among them, N(0, 0.5)) and carried to the port through
``rsprompter_tpu_torch.utils.convert``. The same seeded synthetic batch goes
through ``RSPrompterAnchor.loss`` under ``jax.value_and_grad`` and through
the port's loss and backward, with the samplers given the uniforms JAX's own
key splits produce. fp32 on both sides (the CPU path runs the plain versions
of the kernels through their ``autograd.Function``s).

Tolerances: loss terms 1e-4 relative. Gradients, per parameter tensor,
max|port - JAX| / max|JAX|: at most 2e-2 for every tensor, and the median
tensor within 1e-5. The spread is not the kernels': fp32 sums run in
another order, and a ReLU input within rounding of zero may fall on the
other side and switch its gradient on or off (on weights from JAX's own
init, two of the bbox head's 59392 first-layer pre-activations did, and the
bbox branch read 9.3e-3; on these weights no input does, and the worst
tensor reads 5.6e-5). A float64 run of the port agrees with JAX's fp32
gradients to 3.7e-5 (held to 1e-4 for every tensor below). Tensors whose
true gradient is zero (a bias before a
BatchNorm, a key bias under softmax: about 1e-9 of noise) are held to 1e-6
of the largest gradient instead. BatchNorm statistics 1e-5; the optimizer
update on identical gradients 1e-6 (lr 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
from rsprompter_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rsprompter_tpu.engine.optim import warmup_cosine_schedule as jax_schedule
from rsprompter_tpu.engine.train_state import total_loss as jax_total_loss
from rsprompter_tpu.models import losses as jl
from rsprompter_tpu.models.task_modules.assigners import max_iou_assign as jax_assign
from rsprompter_tpu.models.task_modules.samplers import random_sample_padded as jax_sample
from rsprompter_tpu_torch.apis.build import build_detector, freeze_paths_for
from rsprompter_tpu_torch.engine.optim import build_optimizer, warmup_cosine_schedule
from rsprompter_tpu_torch.engine.train_state import build_trainer, total_loss
from rsprompter_tpu_torch.models import losses as tl
from rsprompter_tpu_torch.models.sam.common import BatchNorm2d
from rsprompter_tpu_torch.models.task_modules.assigners import max_iou_assign
from rsprompter_tpu_torch.models.task_modules.samplers import random_sample_padded
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch
from test_torch_query import _random_variables

LOSS_TOL = 1e-4
GRAD_TOL = 2e-2
GRAD_MEDIAN_TOL = 1e-5
GRAD_F64_TOL = 1e-4
IMAGE = 64
GRID = IMAGE // 8
TINY = dict(
    type="RSPrompterAnchor",
    bf16=False,
    num_classes=3,
    prompt_shape=(10, 3),
    image_size=IMAGE,
    select_layers=(1, 2),
    aggregator_hidden=8,
    vision_config=dict(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        global_attn_indexes=(1,), image_size=IMAGE, patch_size=8, window_size=3,
        output_channels=32,
    ),
    rpn_strides=(2, 4, 8, 16, 32),
    roi_strides=(2, 4, 8, 16),
    num_samples=32,
    pos_fraction=0.25,
    train_backbone=True,
    decoder_freeze=False,
    train_cfg=dict(
        rpn=dict(num=64, pos_fraction=0.5),
        rpn_proposal=dict(nms_pre=100, max_per_img=24, pre_nms_total=200),
    ),
)
N_ANCHORS = 6 * sum(s * s for s in (4 * GRID, 2 * GRID, GRID, GRID // 2, GRID // 4))
N_PROPOSALS = 24


def jax_draws(key, b, max_gt):
    """The uniforms JAX's ``loss`` draws: rpn / roi streams, one key per
    image, three per sampler (``random_sample_padded``), as (3, B, P)."""
    sizes = {"rpn": N_ANCHORS, "roi": max_gt + N_PROPOSALS}
    out = {}
    for name, k in zip(("rpn", "roi"), jax.random.split(key)):
        per = []
        for kb in jax.random.split(k, b):
            per.append([np.asarray(jax.random.uniform(x, (sizes[name],)))
                        for x in jax.random.split(kb, 3)])
        out[name] = torch.from_numpy(np.asarray(per).transpose(1, 0, 2).copy())
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    batch = synthetic_batch(2, (IMAGE, IMAGE), TINY["num_classes"], max_gt=5, seed=1)
    batch["gt_masks"] = batch["gt_masks"].astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jax_build_detector(dict(TINY))
    key = jax.random.PRNGKey(3)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jbatch, key, method="loss"))
    variables = _random_variables(shapes, rng)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": stats}, jbatch, key,
                               method="loss", mutable=["batch_stats"])
        return jax_total_loss(out), (out, upd)

    (_, (jlosses, upd)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    state = jax_to_state_dict({"params": params, "batch_stats": stats})
    draws = jax_draws(key, 2, 5)
    tmodel = build_detector(dict(TINY))
    tmodel.load_state_dict(state)
    tmodel.train()
    tlosses = tmodel.loss(_torch_batch(batch), draws=draws)
    total_loss(tlosses).backward()
    return dict(
        batch=batch, state=state, draws=draws,
        jlosses={k: float(v) for k, v in jlosses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        jgrads=jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}),
        tgrads={n: p.grad for n, p in tmodel.named_parameters()},
        jstats=jax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"])}),
        tstate=tmodel.state_dict(),
        params=params, jgrads_tree=jgrads, model=tmodel,
    )


def test_train_losses_match_jax(case):
    jl_, tl_ = case["jlosses"], case["tlosses"]
    assert set(jl_) == set(tl_) == {
        "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc", "loss_mask"}
    assert tl_["loss_mask"] > 0 and tl_["loss_bbox"] > 0
    for k in jl_:
        np.testing.assert_allclose(tl_[k], jl_[k], rtol=LOSS_TOL, atol=1e-6, err_msg=k)


def test_every_parameter_gradient_matches_jax(case):
    jg, tg = case["jgrads"], case["tgrads"]
    assert set(jg) == set(tg)
    floor = 1e-6 * max(float(g.abs().max()) for g in jg.values())
    worst = {}
    for name, ref in jg.items():
        got = tg[name]
        scale = float(ref.abs().max())
        if scale == 0.0:  # a branch the loss does not reach (the IoU head)
            assert got is None or float(got.abs().max()) == 0.0, name
            continue
        assert got is not None, name
        err = float((got - ref).abs().max())
        if scale <= floor:  # a gradient that is zero up to rounding
            assert err <= floor, name
            continue
        worst[name] = err / scale
    assert max(worst.values()) <= GRAD_TOL, max(worst.items(), key=lambda kv: kv[1])
    assert float(np.median(list(worst.values()))) <= GRAD_MEDIAN_TOL
    # the rel-pos tables and the encoder's first layer do receive gradient
    assert any("rel_pos_h" in n for n in worst) and any("layers.0.mlp" in n for n in worst)


def test_float64_gradients_match_jax_tightly(case):
    """The same step with the port in float64 (its LayerNorm and BatchNorm
    statistics stay fp32): no ReLU flips, so every tensor is held to
    GRAD_F64_TOL, which GRAD_TOL's fp32 spread would hide."""
    model = build_detector(dict(TINY))
    model.load_state_dict(case["state"])
    model.double().train()
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in _torch_batch(case["batch"]).items()}
    losses = model.loss(batch, draws={k: v.double() for k, v in case["draws"].items()})
    total_loss(losses).backward()
    for k, v in case["jlosses"].items():
        assert float(losses[k].detach()) == pytest.approx(v, rel=LOSS_TOL, abs=1e-6), k
    jg = case["jgrads"]
    floor = 1e-6 * max(float(g.abs().max()) for g in jg.values())
    checked = 0
    for name, p in model.named_parameters():
        ref = jg[name].double()
        scale = float(ref.abs().max())
        if scale <= floor:  # unreached, or zero up to rounding: checked above
            continue
        err = float((p.grad - ref).abs().max())
        assert err <= GRAD_F64_TOL * scale, (name, err / scale)
        checked += 1
    assert checked > 100


def test_batchnorm_running_stats_match_flax(case):
    for name, ref in case["jstats"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(case["tstate"][name].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_optimizer_step_matches_optax(case):
    """The port's optimizer fed JAX's gradients moves the parameters as
    ``build_optimizer`` + ``optax.apply_updates`` does (clip 0.01 so the clip
    acts; lr 1e-3 without warm-up; weight decay 0.05)."""
    params, jgrads = case["params"], case["jgrads_tree"]
    sched = jax_schedule(1e-3, 100, 0)
    tx, _ = jax_build_optimizer(params, total_steps=100, warmup_steps=0, grad_clip=0.01,
                                schedule=sched, freeze_paths=["mask_decoder"])
    # whole-tree programs: optax's tree functions run eagerly would dispatch
    # (and compile) each leaf's operations one by one
    updates, _ = jax.jit(tx.update)(jgrads, jax.jit(tx.init)(params), params)
    ref = jax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jax.jit(optax.apply_updates)(params, updates))})

    model = build_detector(dict(TINY))
    model.load_state_dict(jax_to_state_dict({"params": params}), strict=False)
    opt = build_optimizer(model, total_steps=100, warmup_steps=0, grad_clip=0.01,
                          schedule=warmup_cosine_schedule(1e-3, 100, 0),
                          freeze_paths=["mask_decoder"])
    grads = case["jgrads"]
    for name, p in model.named_parameters():
        p.grad = grads[name].clone()
    grad_norm = opt.step()  # over every gradient, the frozen decoder's too
    assert opt.lr == pytest.approx(float(sched(0)))
    assert float(grad_norm) == pytest.approx(float(jax.jit(optax.global_norm)(jgrads)),
                                             rel=1e-6)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        moved += "mask_decoder" not in name
    assert moved > 0


@pytest.mark.parametrize("step", [0, 1, 7, 50, 51, 300, 5000])
def test_warmup_cosine_schedule_matches_optax(step):
    ours = warmup_cosine_schedule(2e-4, 1000, 50)
    ref = jax_schedule(2e-4, 1000, 50)
    assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5)  # optax: fp32


def test_freeze_paths_match_jax():
    """Every family, with and without ``peft_config`` and ``train_backbone``
    (and the anchor and query variants with and without ``decoder_freeze``):
    the port's (freeze, override) equal to JAX's. SAM-det freezes its SAM
    (``segmentor``) whatever the keys, and trains its ResNet."""
    peft = dict(r=4, lora_alpha=8, target_modules=["qkv"])
    families = ("RSPrompterAnchor", "RSPrompterQuery", "SAMDet", "SAMSegMaskRCNN",
                "SAMSegMask2Former")
    checked = set()
    for mtype in families:
        for extra in ({}, dict(peft_config=peft), dict(train_backbone=True),
                      dict(train_backbone=False), dict(decoder_freeze=False),
                      dict(peft_config=peft, decoder_freeze=False)):
            cfg = dict(type=mtype, **extra)
            want = jax_freeze_paths_for(cfg)
            assert freeze_paths_for(cfg) == want, (cfg, want)
            checked.add((mtype, tuple(want[0]), tuple(want[1])))
    assert ("SAMDet", ("segmentor",), ()) in checked
    assert ("SAMSegMaskRCNN", ("backbone",), ("lora_a", "lora_b")) in checked
    for cfg in (dict(TINY), dict(TINY, train_backbone=False, decoder_freeze=True)):
        freeze, override = jax_freeze_paths_for(cfg)
        assert override == [] and freeze_paths_for(cfg) == (freeze, override)


def test_default_config_freezes_encoder_and_decoder():
    """``train_backbone`` off and ``decoder_freeze`` on: after one step the
    encoder and the SAM decoder are unchanged, no gradient reaches the
    encoder, and point_emb trains through the frozen decoder."""
    cfg = dict(TINY, train_backbone=False, decoder_freeze=True)
    trainer = build_trainer({"model": cfg, "base_lr": 1e-3, "warmup_iters": 0},
                            device="cpu", seed=0)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    batch = _torch_batch(synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=5, seed=2))
    metrics = trainer.step(batch, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    for name, p in trainer.model.named_parameters():
        frozen = name.startswith("backbone") or any(
            k in name for k in ("mask_decoder", "shared_image_embedding", "no_mask_embed"))
        changed = not torch.equal(p, before[name])
        if frozen:
            assert not changed, name
        if name.startswith("backbone"):
            assert p.grad is None, name
    point_emb = [p for n, p in trainer.model.named_parameters() if "point_emb.8" in n]
    assert all(float(p.grad.abs().max()) > 0 for p in point_emb)
    assert all(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters()
               if "point_emb.8" in n)


def test_bf16_training_keeps_fp32_master_weights():
    """``bf16=True``: the layers compute in bf16, the parameters, their
    gradients and the AdamW update stay fp32 (JAX's ``dtype=bf16`` with fp32
    params); predict's in-place cast is not used for training."""
    trainer = build_trainer({"model": dict(TINY, bf16=True)}, device="cpu", seed=0)
    batch = _torch_batch(synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=5, seed=2))
    metrics = trainer.step(batch, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    model = trainer.model
    assert model.rpn_head.rpn_conv.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters() if p.grad is not None} == {torch.float32}
    feats = model.extract_feat(batch["images"])[0]
    assert feats[0].dtype == torch.bfloat16


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trainer({"model": dict(TINY)})


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics with flax's BIASED variance update the running
    variance; ``nn.BatchNorm2d``'s unbiased one would be off by n / (n - 1)."""
    import flax.linen as fnn

    x = np.random.default_rng(4).standard_normal((2, 3, 3, 5)).astype(np.float32) * 2 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_ref, upd = bn.apply(v, x, mutable=["batch_stats"])
    tbn = BatchNorm2d(5).train()
    y = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    ref_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(tbn.running_var.numpy(), ref_var, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    unbiased = torch.nn.BatchNorm2d(5, momentum=0.1).train()
    unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(unbiased.running_var.numpy() - ref_var).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_and_sample_match_jax(seed):
    """Max-IoU assignment and the padded sampler, given JAX's uniforms,
    pick exactly the same slots."""
    rng = np.random.default_rng(seed)
    p, g = 300, 6
    xy = rng.uniform(0, 80, (p, 2))
    priors = np.concatenate([xy, xy + rng.uniform(4, 30, (p, 2))], 1).astype(np.float32)
    gxy = rng.uniform(0, 80, (g, 2))
    gtb = np.concatenate([gxy, gxy + rng.uniform(8, 30, (g, 2))], 1).astype(np.float32)
    gtl = rng.integers(0, 3, g)
    gtv = np.arange(g) < 4
    ja = jax_assign(jnp.asarray(priors), jnp.asarray(gtb), jnp.asarray(gtl),
                    jnp.asarray(gtv), 0.5, 0.4, 0.3)
    ta = max_iou_assign(torch.from_numpy(priors), torch.from_numpy(gtb)[None],
                        torch.from_numpy(gtv)[None], 0.5, 0.4, 0.3)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja.gt_inds))
    key = jax.random.PRNGKey(seed)
    js = jax_sample(key, ja.gt_inds, num=64, pos_fraction=0.25)
    draws = np.stack([np.asarray(jax.random.uniform(k, (p,))) for k in jax.random.split(key, 3)])
    ts = random_sample_padded(ta, torch.from_numpy(draws)[:, None], 64, 0.25)
    for got, ref in zip(ts, js):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["cross_entropy", "binary_cross_entropy", "smooth_l1",
                                  "mask_cross_entropy", "accuracy"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    w = (rng.uniform(size=12) > 0.3).astype(np.float32)
    if name == "cross_entropy":
        x, lab = rng.standard_normal((12, 4)).astype(np.float32), rng.integers(0, 4, 12)
        args_j = (jnp.asarray(x), jnp.asarray(lab), jnp.asarray(w), 7.0)
        args_t = (torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(w), 7.0)
    elif name == "binary_cross_entropy":
        x, t = rng.standard_normal(12).astype(np.float32) * 3, (rng.uniform(size=12) > 0.5)
        args_j = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(w), 5.0)
        args_t = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(w), 5.0)
    elif name == "smooth_l1":
        x, t = rng.standard_normal((12, 4)).astype(np.float32), rng.standard_normal((12, 4))
        args_j = (jnp.asarray(x), jnp.asarray(t, jnp.float32), 1.0, jnp.asarray(w)[:, None], 3.0)
        args_t = (torch.from_numpy(x), torch.from_numpy(t).float(), 1.0,
                  torch.from_numpy(w)[:, None], 3.0)
    elif name == "mask_cross_entropy":
        x, t = rng.standard_normal((12, 6, 5)).astype(np.float32), rng.uniform(size=(12, 6, 5)) > 0.5
        args_j = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(w > 0))
        args_t = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(w > 0))
    else:
        x, lab = rng.standard_normal((12, 4)).astype(np.float32), rng.integers(0, 4, 12)
        args_j = (jnp.asarray(x), jnp.asarray(lab), jnp.asarray(w > 0))
        args_t = (torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(w > 0))
    ref = float(getattr(jl, name)(*args_j))
    got = float(getattr(tl, name)(*args_t))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
