"""The port's RSPrompter-query train step held against the JAX package.

The tiny query model of ``tests/test_torch_query.py`` (encoder hidden 128,
two heads, two layers; 128^2 input; six queries of five points; the full
six-layer Mask2Former decoder, so seven head calls) with the encoder and
the SAM decoder trainable (``train_backbone=True``, ``decoder_freeze=False``)
and ``num_points`` cut to 48 (144 candidates, 36 kept by uncertainty, 12
uniform). Its JAX variables are drawn with numpy on ``jax.eval_shape``'s
shapes and carried to the port through ``rsprompter_tpu_torch.utils.convert``.
One seeded synthetic batch goes through ``RSPrompterQuery.loss`` under one
``jax.jit(jax.value_and_grad(...))`` and through the port's loss and
backward, the port given the uniforms of JAX's own key splits (``draws``).
fp32 on both sides (the port's encoder runs the plain versions of its
kernels through their ``autograd.Function``s). Each side differentiates its
own ``total_loss``, JAX's being what its ``make_train_step`` minimises: the
terms whose name starts with ``loss``, so the last head call's five (the
six auxiliary calls' terms are reported and compared, and do not train).

JAX's ``hungarian_match_batched`` is run on its scipy route (its own
single-device CPU path, ``_lsa_host_batched`` through ``pure_callback``):
the tests' eight-device platform would send it to the TPU auction, which is
optimal only to within G x 1e-3 and which the port does not port.

Tolerances, and why they hold:
- loss terms 1e-4 relative: the same matches and the same points, sums in
  another order;
- matched queries and selected point coordinates exactly equal: the costs
  agree to about 1e-6 and the assignment's optimum is separated by far
  more; the uncertainties are sampled with JAX's bf16 numbers and ranked
  with a stable sort, which breaks ties as ``lax.top_k`` does;
- gradients, per parameter tensor, max|port - JAX| / max|JAX| at most 2e-2
  and the median tensor within 1e-5 (the anchor train test's rule: fp32
  sums in another order, and a ReLU input within rounding of 0 may switch
  its gradient); tensors whose true gradient is zero (a bias before a
  BatchNorm, a key bias under softmax) are held to 1e-6 of the largest;
- the samplers: the loss sampler's value and its bf16 mask gradient equal
  to 1e-6 relative (the same bf16 products, rounded once in fp32), the
  shared sampler and the costs to 1e-6.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
from rsprompter_tpu.engine.train_state import total_loss as jax_total_loss
from rsprompter_tpu.models.dense_heads import mask2former_head as jax_head_mod
from rsprompter_tpu.models.task_modules import hungarian as jh
from rsprompter_tpu.ops import point_utils as jpu
from rsprompter_tpu_torch.apis.build import build_detector, freeze_paths_for
from rsprompter_tpu_torch.engine.train_state import build_trainer, total_loss
from rsprompter_tpu_torch.models.dense_heads import mask2former_head as head_mod
from rsprompter_tpu_torch.models.task_modules import hungarian as th
from rsprompter_tpu_torch.ops import point_utils as tpu
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch
from test_torch_query import TINY as QUERY_TINY
from test_torch_query import FAST_COMPILE, _random_variables

LOSS_TOL = 1e-4
GRAD_TOL = 2e-2
GRAD_MEDIAN_TOL = 1e-5
SAMPLER_TOL = 1e-6
IMAGE = 128
MAX_GT = 5
NUM_POINTS = 48
TINY = dict(QUERY_TINY, train_backbone=True, decoder_freeze=False,
            train_cfg=dict(num_points=NUM_POINTS, oversample_ratio=3.0,
                           importance_sample_ratio=0.75))
QUERY_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs", "rsprompter", "rsprompter_query-nwpu.py")
N_CALLS = 7
TERMS = ("loss_cls", "loss_mask", "loss_dice", "loss_mask_plus", "loss_dice_plus")


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, b, g, num_points=NUM_POINTS):
    """The uniforms JAX's ``loss`` draws, per head call ``li``: the match
    points from ``split(fold_in(key, li))[0]``; the candidates and fill
    points from the two halves of ``split(...)[1]``."""
    k_cand, k_rand = tpu.point_draw_shapes(num_points, 3.0, 0.75)
    out = {"match": [], "cand": [], "rand": []}
    for li in range(N_CALLS):
        r_match, r_pts = jax.random.split(jax.random.fold_in(key, li))
        r1, r2 = jax.random.split(r_pts)
        out["match"].append(jax.random.uniform(r_match, (b, num_points, 2)))
        out["cand"].append(jax.random.uniform(r1, (b * g, k_cand, 2)))
        out["rand"].append(jax.random.uniform(r2, (b * g, k_rand, 2)))
    return {k: _t(np.stack(v)) for k, v in out.items()}


def _run_case():
    """One step of both packages on the same batch and draws; the matches
    and point coordinates each recorded on its way."""
    rng = np.random.default_rng(0)
    batch = synthetic_batch(2, (IMAGE, IMAGE), TINY["num_classes"], max_gt=MAX_GT, seed=1)
    assert 1 < batch["gt_valid"].sum(1).max() < MAX_GT
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jax_build_detector(dict(TINY))
    key = jax.random.PRNGKey(3)
    rec = {"matched": [], "coords": {}}
    counter = itertools.count()

    def scipy_match(cost, gt_valid):  # JAX's single-device CPU route, recorded
        *lead, q, g = cost.shape
        n = int(np.prod(lead))

        def solve(c, v):
            out = jh._lsa_host_batched(np.asarray(c), np.asarray(v))
            rec["matched"].append(out.reshape(*lead, g))
            return out

        return jax.pure_callback(
            solve, jax.ShapeDtypeStruct((n, g), jnp.int32),
            cost.astype(jnp.float32).reshape(n, q, g), gt_valid.reshape(n, g),
            vmap_method="sequential",
        ).reshape(*lead, g)

    def recorded_coords(*a, **kw):  # calls in order: per head call, SAM then plus
        out = jpu.uncertain_point_coords(*a, **kw)
        i = next(counter)
        jax.debug.callback(lambda c: rec["coords"].__setitem__(i, np.asarray(c)), out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_head_mod, "hungarian_match_batched", scipy_match)
        mp.setattr(jax_head_mod, "uncertain_point_coords", recorded_coords)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0)}, jbatch, key, method="loss"))
        variables = _random_variables(shapes, rng)
        params, stats = variables["params"], variables.get("batch_stats", {})

        def loss_fn(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, jbatch, key,
                                 method="loss", mutable=["batch_stats"])
            return jax_total_loss(out), out

        counter = itertools.count()
        rec["matched"].clear()
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, jlosses), jgrads = step.lower(params).compile(compiler_options=FAST_COMPILE)(params)
        jax.block_until_ready(jgrads)

    got = {"matched": [], "coords": []}

    def port_match(cost, valid):
        out = th.hungarian_match_batched(cost, valid)
        got["matched"].append(out)
        return out

    def port_coords(*a, **kw):
        out = tpu.uncertain_point_coords(*a, **kw)
        got["coords"].append(out)
        return out

    state = jax_to_state_dict(variables)
    tmodel = build_detector(dict(TINY))
    tmodel.load_state_dict(state)
    tmodel.train()
    draws = jax_draws(key, 2, MAX_GT)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(head_mod, "hungarian_match_batched", port_match)
        mp.setattr(head_mod, "uncertain_point_coords", port_coords)
        tlosses = tmodel.loss(tbatch, draws=draws)
    total_loss(tlosses).backward()
    return dict(
        batch=batch, rec=rec, got=got,
        jlosses={k: float(v) for k, v in jlosses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        jgrads=jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jgrads)}),
        tgrads={n: p.grad for n, p in tmodel.named_parameters()},
    )


def _check_losses(case):
    jl_, tl_ = case["jlosses"], case["tlosses"]
    names = {p + t for p in [f"d{i}." for i in range(N_CALLS - 1)] + [""] for t in TERMS}
    assert set(jl_) == set(tl_) == names and len(names) == 35
    for k in jl_:
        assert tl_[k] > 0, k
        np.testing.assert_allclose(tl_[k], jl_[k], rtol=LOSS_TOL, atol=1e-6, err_msg=k)


def _check_matches(case):
    """One host solve over all seven calls' cost matrices; every GT matched
    to the same query, -1 exactly at invalid GT, one-to-one per image."""
    (jm,), (tm,) = case["rec"]["matched"], case["got"]["matched"]
    tm = tm.numpy()
    assert tm.shape == jm.shape == (N_CALLS, 2, MAX_GT)
    np.testing.assert_array_equal(tm, jm)
    valid = case["batch"]["gt_valid"]
    assert ((tm == -1) == ~valid[None]).all()
    for li, bi in itertools.product(range(N_CALLS), range(2)):
        picked = tm[li, bi][valid[bi]]
        assert len(set(picked.tolist())) == len(picked)


def _check_points(case):
    """The importance-sampled coordinates of both streams, every call."""
    jc, tc = case["rec"]["coords"], case["got"]["coords"]
    assert sorted(jc) == list(range(2 * N_CALLS)) and len(tc) == 2
    for stream in range(2):
        port = tc[stream].numpy().reshape(N_CALLS, 2 * MAX_GT, NUM_POINTS, 2)
        for li in range(N_CALLS):
            np.testing.assert_array_equal(port[li], jc[2 * li + stream],
                                          err_msg=f"call {li}, stream {stream}")


GRAD_PARTS = ("backbone.layers.0.mlp", "rel_pos_h", "pixel_decoder", "mask_decoder",
              "sam_mask_embed", "point_emb", "mask_embed", "cls_embed",
              "shared_image_embedding", "neck_feature_aggregator")


def _check_gradients(case, parts=GRAD_PARTS):
    """Every gradient within ``GRAD_TOL`` of JAX's, the median tensor within
    ``GRAD_MEDIAN_TOL``, and some tensor of each of ``parts`` checked."""
    jg, tg = case["jgrads"], case["tgrads"]
    assert set(jg) == set(tg)
    floor = 1e-6 * max(float(g.abs().max()) for g in jg.values())
    worst = {}
    for name, ref in jg.items():
        got = tg[name]
        scale = float(ref.abs().max())
        if scale == 0.0:  # the IoU head: RSPrompter trains no IoU target
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
    for part in parts:
        assert any(part in n for n in worst), part


def test_query_train_step_matches_jax():
    """(a) every loss term, (b) the matches, (c) the selected points and (d)
    every parameter's gradient, encoder included, against JAX's step. One
    test, so the JAX compile (about a minute) runs once whatever the
    workers."""
    case = _run_case()
    _check_losses(case)
    _check_matches(case)
    _check_points(case)
    _check_gradients(case)


def _sampler_inputs(seed, n=6, h=9, w=11, p=40):
    rng = np.random.default_rng(seed)
    masks = (rng.standard_normal((n, h, w)) * 3).astype(np.float32)
    pts = rng.uniform(-0.05, 1.05, (n, p, 2)).astype(np.float32)  # some outside
    return masks, pts, rng.standard_normal((n, p)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_sampler_and_its_gradient_match_jax(seed):
    masks, pts, g = _sampler_inputs(seed)

    def fwd_bwd(m, g):  # one program: an eager vjp compiles each operation alone
        out, vjp = jax.vjp(lambda m: jpu.sample_mask_points_matmul(m, jnp.asarray(pts)), m)
        return out, vjp(g)[0]

    out, dm = jax.jit(fwd_bwd)(masks, jnp.asarray(g))
    tm = _t(masks).requires_grad_(True)
    tout = tpu.sample_mask_points_bf16(tm, _t(pts))
    tout.backward(_t(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(dm), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)
    # leading batch dimensions and integer (GT) masks
    u8 = (masks > 0).astype(np.uint8)
    ref = jpu.sample_mask_points_matmul(jnp.asarray(u8, jnp.float32), jnp.asarray(pts))
    got = tpu.sample_mask_points_bf16(_t(u8)[None].expand(2, -1, -1, -1),
                                      _t(pts)[None].expand(2, -1, -1, -1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref))


def test_shared_and_grid_samplers_match_jax():
    masks, pts, _ = _sampler_inputs(2)
    ref = jax.jit(jpu.sample_mask_points_shared)(masks, pts[0])
    got = tpu.sample_mask_points_shared(_t(masks), _t(pts[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SAMPLER_TOL,
                               atol=SAMPLER_TOL)
    stacked = tpu.sample_mask_points_shared(_t(masks)[None].expand(3, -1, -1, -1),
                                            _t(pts[:3]))
    np.testing.assert_array_equal(stacked[0].numpy(), got.numpy())
    ref = jax.jit(jpu.sample_mask_points)(masks, pts)
    np.testing.assert_allclose(tpu.sample_mask_points(_t(masks), _t(pts)).numpy(),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_uncertain_points_break_ties_as_top_k():
    """Equal uncertainties (masks of a constant and points in the same
    pixels) keep the lowest candidate index first, as ``lax.top_k``."""
    rng = np.random.default_rng(3)
    masks = np.round(rng.standard_normal((3, 4, 4)) * 2) / 2
    masks = masks.astype(np.float32)
    key = jax.random.PRNGKey(5)
    r1, r2 = jax.random.split(key)
    ref = jpu.uncertain_point_coords(key, jnp.asarray(masks), 16, 3.0, 0.75,
                                     sampler=jpu.sample_mask_points_matmul)
    cand = jax.random.uniform(r1, (3, 48, 2))
    rand = jax.random.uniform(r2, (3, 4, 2))
    got = tpu.uncertain_point_coords(_t(masks), _t(cand), _t(rand), 16, 0.75)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    values = tpu.sample_mask_points_bf16(_t(masks), _t(cand)).abs()
    assert len(np.unique(values.numpy())) < values.numel()  # ties did occur


@pytest.mark.parametrize("q,g,n_valid", [(6, 5, 3), (3, 5, 5), (4, 4, 0)])
def test_costs_and_assignment_match_jax(q, g, n_valid):
    """The three pairwise costs and scipy's assignment, including more valid
    GT than queries (the extra GT stay -1) and no valid GT."""
    rng = np.random.default_rng(q * 10 + g)
    cls = rng.standard_normal((q, 4)).astype(np.float32)
    labels = rng.integers(0, 3, g)
    pred = (rng.standard_normal((q, 30)) * 3).astype(np.float32)
    gt = (rng.uniform(size=(g, 30)) > 0.5).astype(np.float32)
    for name in ("classification_cost", "bce_cost", "dice_cost"):
        args = (cls, labels) if name == "classification_cost" else (pred, gt)
        ref = getattr(jh, name)(*map(jnp.asarray, args))
        got = getattr(th, name)(*map(_t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SAMPLER_TOL,
                                   atol=SAMPLER_TOL, err_msg=name)
    cost = rng.standard_normal((2, 3, q, g)).astype(np.float32)
    cost[0, 1, 0, 0] = np.nan
    valid = np.zeros((3, g), bool)
    valid[:, :n_valid] = True
    ref = jh._lsa_host_batched(cost.reshape(6, q, g), np.broadcast_to(valid, (2, 3, g))
                               .reshape(6, g)).reshape(2, 3, g)
    got = th.hungarian_match_batched(_t(cost), _t(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[~np.broadcast_to(valid, got.shape)] == -1).all()
    assert (got >= 0).sum(-1).max() <= min(q, n_valid)


@pytest.mark.parametrize("cfg", [
    dict(TINY),
    dict(TINY, train_backbone=False, decoder_freeze=True),
    dict(TINY, train_backbone=False, decoder_freeze=False),
])
def test_query_freeze_paths_match_jax(cfg):
    freeze, override = jax_freeze_paths_for(cfg)
    assert override == [] and freeze_paths_for(cfg) == (freeze, override)


def test_query_config_freezes_encoder_and_steps():
    """The config's freeze rules on the tiny model (encoder frozen, SAM
    decoder trained, as ``rsprompter_query-nwpu.py``) through
    ``build_trainer(..., device='cpu')``: the encoder is unchanged and gets
    no gradient, the heads and the SAM decoder move; all 35 terms are
    reported and the total is the last call's five, as JAX's."""
    cfg = dict(TINY, train_backbone=False, bf16=True)
    trainer = build_trainer({"model": cfg, "base_lr": 1e-3, "warmup_iters": 0},
                            device="cpu", seed=0)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    batch = {k: _t(v) for k, v in synthetic_batch(2, (IMAGE, IMAGE), 3, max_gt=MAX_GT,
                                                   seed=2).items()}
    metrics = trainer.step(batch, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    terms = [k for k in metrics if "loss" in k and k != "loss"]
    assert len(terms) == 35
    assert float(metrics["loss"]) == pytest.approx(sum(float(metrics[k]) for k in TERMS),
                                                   rel=1e-5)
    assert all(n.startswith("panoptic_head.mask_decoder.iou_prediction_head")
               for n in trainer.optimizer.unreached)
    for name, p in trainer.model.named_parameters():
        if name.startswith("backbone"):
            assert p.grad is None and torch.equal(p, before[name]), name
    for part in ("mask_decoder.transformer", "point_emb", "sam_mask_embed", "cls_embed",
                 "mask_embed", "pixel_decoder", "transformer_decoder"):
        assert any(part in n and not torch.equal(p, before[n])
                   for n, p in trainer.model.named_parameters()), part


def test_query_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_trainer(QUERY_CONFIG)
