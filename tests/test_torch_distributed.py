"""The port's data parallelism on the CPU: two gloo ranks against JAX's
sharded step and against the port's own single process.

(a) The anchor train step at world 2 (two spawned ranks, one image each,
    ZeRO on) against JAX's ``make_sharded_train_step`` over a 2-device mesh
    of the conftest's virtual CPU devices (``zero=True``): the tiny detector
    and batch of ``tests/test_torch_train.py``, the same weights
    (``utils.convert``) and JAX's uniforms (its step folds the step count
    into its key; each rank keeps its rows of the global draws). JAX's
    gradients are read from its first moments (one AdamW step from zero:
    mu = 0.1 g, no clip). Held to ``test_torch_train.py``'s tolerances:
    loss terms 1e-4 relative, gradients 2e-2 of each tensor's largest with
    the median tensor within 1e-5, BatchNorm statistics 1e-5.
(b) World 2 against one process on the global batch, the anchor (the same
    draws) and the query family (draws from the generator, seeded alike on
    every rank), both in float64 (the default dtype; BatchNorm's statistics
    in float64, LayerNorm's and the SAM decoder's attention scores in
    fp32): every gradient within 1e-5 of its tensor's largest; tensors
    whose true gradient is zero (a bias before a BatchNorm, a key bias
    under softmax) are held to 1e-6 of the largest gradient instead, as the
    train tests hold them. (In fp32, or with fp32 BatchNorm sums, a
    gradient that cancels, as a key projection's under softmax, reads
    3e-5 to 4.5e-5 of its largest between the two: the statistics' sum,
    split in two, rounds otherwise.) Three
    fp32 steps with ZeRO on and off give parameters within 1e-6; the ranks'
    parameters are equal bit for bit.
(c) ``TrainLoader`` shards are disjoint and cover the (cut) data set, as
    JAX's ``test_loader_shards_are_disjoint_and_cover``; the test side's
    blocks cover it in order.
(d) ``initialize()``'s failure policy, as JAX's
    ``test_initialize_failure_policy``; ``mesh_from_config``'s refusals.
(e) ``tools.train`` at world 2: three epochs straight against a run
    resumed from the straight run's step-4 checkpoint, equal bit for bit
    (parameters, BN buffers, moments, the sharded validation's record);
    that world-2 checkpoint resumes at world 1.
(f) ``tools.test`` at world 2 on five images (not divisible by 2): its
    metrics equal the single process's to 1e-6, every image counted once.

Two spawns (``parallel.launch``), each in one test: the two ranks of (a)
and (b), while JAX compiles its step (the one JAX ``value_and_grad``
compile of this file); the two ranks of (e) and (f). JAX is imported
inside the tests: the spawned ranks import this module to find their
functions.
"""

import concurrent.futures
import hashlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from rsprompter_tpu_torch.data.loader import DataLoader, TrainLoader
from rsprompter_tpu_torch.engine.checkpoint import load_train_checkpoint
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.parallel import distributed, launch
from rsprompter_tpu_torch.parallel.mesh import mesh_from_config
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch

LOSS_TOL = 1e-4
GRAD_TOL = 2e-2
GRAD_MEDIAN_TOL = 1e-5
STATS_TOL = 1e-5
DP_GRAD_TOL = 1e-5  # world 2 against one process: the same sums, split in two
ZERO_FLOOR = 1e-6  # of the largest gradient, for tensors whose gradient is zero
ZERO_TOL = 1e-6
METRIC_TOL = 1e-6
WORLD = 2
# JAX's step compiles without LLVM's optimisations (a third less compile time)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
THREADS = 2  # each rank's torch threads


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _rows(batch, rank, n):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
            for k, v in batch.items()}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _trainer(model_cfg, zero=True):
    return build_trainer({"model": dict(model_cfg), "base_lr": 1e-3, "warmup_iters": 0,
                          "dist": {"zero": zero}}, device="cpu", seed=0)


def _float64_steps(anchor, query, rank, world):
    """(b)'s steps in float64: the anchor on ``draws``, the query family on
    the generator; (anchor metrics, gradients, query metrics, gradients)."""
    cfg, state, batch, draws = anchor
    qcfg, qbatch = query
    torch.set_default_dtype(torch.float64)
    try:
        trainer = _trainer(cfg)
        trainer.model.load_state_dict(state)
        metrics = trainer.step(_rows(batch, rank, batch["images"].shape[0] // world),
                               draws=draws)
        qtrainer = _trainer(qcfg)
        qmetrics = qtrainer.train_step(_rows(qbatch, rank, qbatch["images"].shape[0] // world))
    finally:
        torch.set_default_dtype(torch.float32)
    return ({k: float(v) for k, v in metrics.items()}, _grads(trainer.model),
            {k: float(v) for k, v in qmetrics.items()}, _grads(qtrainer.model))


def _one_process(anchor, query):
    """(b)'s references, one process on the global batch: the fp32 anchor
    step's BatchNorm statistics, then the float64 steps."""
    cfg, state, batch, draws = anchor
    single = _trainer(cfg)
    single.model.load_state_dict(state)
    single.step(_rows(batch, 0, batch["images"].shape[0]), draws=draws)
    stats = {k: v.clone() for k, v in single.model.state_dict().items() if "running" in k}
    return stats, _float64_steps(anchor, query, 0, 1)


def _step_rank(anchor, query):
    """One rank of (a) and (b). Returns the first fp32 anchor step's
    metrics, gradients and BN statistics, the three-step ZeRO on / off
    difference, parameter digests, and (b)'s float64 steps (gradients from
    rank 0 alone)."""
    rank, world = distributed.rank(), distributed.world_size()
    cfg, state, batch, draws = anchor
    local = _rows(batch, rank, batch["images"].shape[0] // world)
    out = {}
    runs = []
    for zero in (True, False):
        trainer = _trainer(cfg, zero)
        trainer.model.load_state_dict(state)
        metrics = trainer.step(local, draws=draws)
        if zero:
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            out["grads"] = _grads(trainer.model) if rank == 0 else None
            out["grad_digests"] = {n: _digest(g) for n, g in _grads(trainer.model).items()}
            out["stats"] = {k: v.clone() for k, v in trainer.model.state_dict().items()
                            if "running" in k}
            out["sharded"] = len(trainer.optimizer.adamw.optim.state) < len(
                trainer.optimizer.trained)
        for s in (1, 2):
            trainer.step(local, generator=torch.Generator().manual_seed(s))
        runs.append(dict(trainer.model.named_parameters()))
    on, off = runs
    out["zero_diff"] = max(float((on[n] - off[n]).abs().max()) for n in on)
    out["param_digests"] = {n: _digest(p) for n, p in on.items()}
    out["f64"] = _float64_steps(anchor, query, rank, world) if rank == 0 else None
    if rank:  # the collectives of rank 0's steps
        _float64_steps(anchor, query, rank, world)
    return out


def _close_grads(got, ref, tol, median_tol=None):
    """Per tensor max|got - ref| / max|ref| <= tol (tensors whose reference
    is zero up to rounding: <= ZERO_FLOOR of the largest gradient)."""
    assert set(got) == set(ref)
    floor = ZERO_FLOOR * max(float(g.abs().max()) for g in ref.values())
    worst = {}
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        scale = float(r.abs().max())
        if scale <= floor:
            assert err <= floor, (name, err)
            continue
        worst[name] = err / scale
    assert max(worst.values()) <= tol, max(worst.items(), key=lambda kv: kv[1])
    if median_tol is not None:
        assert float(np.median(list(worst.values()))) <= median_tol
    return worst


def _jax_sharded_step(case):
    """JAX's ``make_sharded_train_step`` on a 2-device mesh, ZeRO on:
    (metrics, gradients of the trained tensors by the port's names, BN
    statistics by the port's names)."""
    import jax
    import jax.numpy as jnp
    import optax

    from rsprompter_tpu.apis.build import build_detector as jax_build_detector
    from rsprompter_tpu.apis.build import freeze_paths_for as jax_freeze_paths_for
    from rsprompter_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from rsprompter_tpu.engine.train_state import TrainState, make_sharded_train_step
    from rsprompter_tpu.parallel.mesh import make_mesh
    from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

    model = jax_build_detector(dict(case["cfg"]))
    freeze, override = jax_freeze_paths_for(case["cfg"])
    tx, _ = jax_build_optimizer(case["params"], base_lr=1e-3, total_steps=100, warmup_steps=0,
                                freeze_paths=freeze, train_paths_override=override)
    # one program, not an eager op for every leaf of AdamW's state
    state = jax.jit(lambda p, s: TrainState.create(p, s, tx))(case["params"], case["stats"])
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    step, sharded = make_sharded_train_step(model, tx, mesh, state, batch, zero=True)
    compiled = step.lower(sharded, batch, case["key"]).compile(compiler_options=FAST_COMPILE)
    new, metrics = compiled(sharded, batch, case["key"])
    mu = optax.tree_utils.tree_get(new.opt_state, "mu")
    assert "data" in str(jax.tree_util.tree_leaves(mu)[0].sharding.spec)  # ZeRO
    grads = jax_to_state_dict({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, mu)})
    stats = jax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, new.batch_stats)})
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _step_case():
    """The anchor case of ``test_torch_train.py`` (weights from JAX's
    shapes, seeded rel-pos tables and BN statistics), the query case of
    ``test_torch_query_train.py`` (the port's seeded weights); the ranks'
    runs, JAX's sharded step, and the single process's steps."""
    import jax

    from rsprompter_tpu.apis.build import build_detector as jax_build_detector
    from rsprompter_tpu_torch.utils.convert import jax_to_state_dict
    from test_torch_query import _random_variables
    from test_torch_query_train import TINY as QUERY_TINY
    from test_torch_train import IMAGE, TINY, jax_draws

    batch = synthetic_batch(WORLD, (IMAGE, IMAGE), TINY["num_classes"], max_gt=5, seed=1)
    batch["gt_masks"] = batch["gt_masks"].astype(np.float32)
    key = jax.random.PRNGKey(3)
    model = jax_build_detector(dict(TINY))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, key, method="loss"))
    variables = _random_variables(shapes, np.random.default_rng(0))
    params, stats = variables["params"], variables["batch_stats"]
    state = jax_to_state_dict(variables)
    # JAX's step draws from fold_in(key, step): the global batch's uniforms
    draws = jax_draws(jax.random.fold_in(key, 0), WORLD, 5)
    qbatch = synthetic_batch(WORLD, (128, 128), 3, max_gt=5, seed=4)
    qbatch["gt_masks"] = qbatch["gt_masks"].astype(np.float32)
    anchor, query = (TINY, state, batch, draws), (QUERY_TINY, qbatch)
    ranks = launch.start_ranks(_step_rank, WORLD, (anchor, query), threads=THREADS)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)  # the ranks' share of the cores, beside JAX's compile
    try:  # while the ranks run: JAX's step, and the one process in a thread beside it
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            one = pool.submit(_one_process, anchor, query)
            case = dict(cfg=TINY, params=params, stats=stats, batch=batch, key=key)
            jax_metrics, jax_grads, jax_stats = _jax_sharded_step(case)
            single_stats, f64 = one.result()
    finally:  # joined on failure too: no rank outlives the test
        torch.set_num_threads(threads)
        results = ranks.join()
    return dict(ranks=results, jax_metrics=jax_metrics, jax_grads=jax_grads,
                jax_stats=jax_stats, single_stats=single_stats, f64=f64)


def test_world2_step_matches_jax_and_one_process():
    """(a) and (b) in one test: one spawn and one JAX compile (xdist deals a
    file's tests to several workers, and each would build a fixture they
    shared)."""
    case = _step_case()
    _check_against_jax(case)
    _check_against_one_process(case)


def _check_against_jax(step_case):
    """(a): losses, ``grad_norm``, gradients and BN statistics."""
    got = step_case["ranks"][0]
    ref = step_case["jax_metrics"]
    assert set(got["metrics"]) == set(ref)
    for k, v in ref.items():
        assert got["metrics"][k] == pytest.approx(v, rel=LOSS_TOL, abs=1e-6), k
    assert got["sharded"]
    jg = step_case["jax_grads"]
    trained = {n: g for n, g in got["grads"].items() if n in jg}
    assert len(trained) > 100
    _close_grads(trained, {n: jg[n] for n in trained}, GRAD_TOL, GRAD_MEDIAN_TOL)
    for name, r in step_case["jax_stats"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["stats"][name].numpy(), r.numpy(), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=name)


def _check_against_one_process(step_case):
    """(b): the anchor and the query family; ZeRO on and off; the ranks
    agree bit for bit."""
    r0, r1 = step_case["ranks"]
    metrics, grads, qmetrics, qgrads = r0["f64"]
    ref_metrics, ref_grads, ref_qmetrics, ref_qgrads = step_case["f64"]
    for got, ref in ((metrics, ref_metrics), (qmetrics, ref_qmetrics)):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k] == pytest.approx(v, rel=LOSS_TOL, abs=1e-6), k
    assert {g.dtype for g in grads.values()} == {torch.float64}
    _close_grads(grads, ref_grads, DP_GRAD_TOL)
    _close_grads(qgrads, ref_qgrads, DP_GRAD_TOL)
    for name, ref in step_case["single_stats"].items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(r0["stats"][name].numpy(), ref.numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=name)
        assert torch.equal(r0["stats"][name], r1["stats"][name]), name
    assert r0["grad_digests"] == r1["grad_digests"]
    assert r0["param_digests"] == r1["param_digests"]
    assert r0["zero_diff"] <= ZERO_TOL


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_are_disjoint_and_cover(shuffle, monkeypatch):
    """(c): three train shards of 11 indices (cut to 9: every rank takes as
    many steps), and the test side's blocks of 11, in order."""

    class Stub(list):
        def __getitem__(self, i):
            return {"img_id": i}

    from rsprompter_tpu_torch.data import loader as loader_mod

    monkeypatch.setattr(loader_mod, "collate_batch",
                        lambda samples, **kw: ([s["img_id"] for s in samples], None))
    seen = []
    for sid in range(3):
        dl = TrainLoader(Stub(range(11)), batch_size=1, shuffle=shuffle, drop_last=False,
                         shard_id=sid, num_shards=3)
        got = [i for idxs, _ in dl for i in idxs]
        assert len(got) == len(set(got)) == len(dl) == 3
        seen.append(set(got))
    assert not (seen[0] & seen[1] or seen[0] & seen[2] or seen[1] & seen[2])
    union = seen[0] | seen[1] | seen[2]
    assert len(union) == 9 and union <= set(range(11))
    if not shuffle:
        assert union == set(range(9))

    class Raw(list):
        def __getitem__(self, i):
            return {"img_id": i, "img_path": "", "ori_shape": (1, 1)}

    order = []
    for sid in range(3):
        dl = DataLoader(Raw(range(11)), batch_size=2, shard_id=sid, num_shards=3)
        mine = [s["img_id"] for samples, _ in dl for s in samples]
        assert len(dl) == math.ceil(len(mine) / 2)
        order += mine
    assert order == list(range(11))


def test_initialize_failure_policy(monkeypatch):
    """(d): with a launcher's environment or arguments, a failed init
    raises; without either the run is single-process, unless
    ``allow_single_process=False``."""
    import torch.distributed as dist

    calls = []

    def boom(*a, **kw):
        calls.append(kw)
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        distributed.initialize("cpu", init_method="tcp://127.0.0.1:1", world_size=2, rank=1)
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"), ("WORLD_SIZE", "2"),
                 ("RANK", "1"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        distributed.initialize("cpu")
    assert calls[-1]["init_method"] == "env://" and calls[-1]["backend"] == "gloo"
    for k in distributed.LAUNCHER_ENV:
        monkeypatch.delenv(k)
    assert distributed.initialize("cpu") == torch.device("cpu")  # single process
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        distributed.initialize("cpu", allow_single_process=False)
    assert len(calls) == 2
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_mesh_from_config_refuses():
    """``dist.model_parallel`` > 1 names the roadmap's entry; ``enable``
    without a launcher says how to launch; the defaults are world 1, ZeRO
    on."""
    assert mesh_from_config(None) == (1, True)
    assert mesh_from_config({"enable": False, "zero": False}) == (1, False)
    with pytest.raises(NotImplementedError, match="Do not port"):
        mesh_from_config({"model_parallel": 2})
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh_from_config({"enable": True})


# --- the tools at world 2 -------------------------------------------------------

N_TRAIN = 4  # one image a rank a step: two steps an epoch at world 2
N_TEST = 5  # not divisible by the world size


def _tools_rank(cfg, straight, split, test_cfg):
    """One rank of (e) and (f): 3 epochs straight, then a run resumed from
    the straight run's step-4 checkpoint; then ``tools.test``."""
    from rsprompter_tpu_torch.tools import test as test_tool
    from rsprompter_tpu_torch.tools import train as train_tool

    runner = train_tool.main([cfg, "--work-dir", straight, "--device", "cpu"])
    assert runner.trainer.iter == 6 and len(runner.train_loader) == 2
    if distributed.is_main():
        shutil.copytree(os.path.join(straight, "ckpts", "step_4"),
                        os.path.join(split, "ckpts", "step_4"))
    distributed.barrier()
    resumed = train_tool.main([cfg, "--work-dir", split, "--device", "cpu", "--resume"])
    report = test_tool.main([test_cfg, "--device", "cpu"])
    return dict(iter=resumed.trainer.iter, epoch=resumed.train_loader.epoch,
                metrics=report["metrics"], digest=report["digest"],
                images=report["timing"]["images"])


def test_tools_at_world2(tmp_path):
    """(e) and (f) in one test: one spawn of two ranks (see above)."""
    case = _tools_case(tmp_path)
    try:
        _check_resume_is_bitwise(case)
        _check_resume_at_world1(case)
        _check_test_tool(case)
    finally:  # train checkpoints of the tiny detector are 268 MB each
        shutil.rmtree(tmp_path, ignore_errors=True)


def _tools_case(root):
    import cv2

    from rsprompter_tpu_torch.tools import test as test_tool
    from rsprompter_tpu_torch.utils.synthetic import synthetic_coco
    from test_torch_train_loop import CLASSES, _write_config

    coco = synthetic_coco(str(root / "coco"), CLASSES,
                          ((64, 80), (70, 64), (60, 90), (72, 66), (66, 70)), cv2.imwrite, seed=1)
    cfg = _write_config(root, coco, train_images=N_TRAIN)
    with open(cfg, "a") as f:  # one image a rank; checkpoints at steps 4 and 6; a validation
        f.write("train_dataloader['batch_size'] = 1\nckpt_interval = 2\nval_interval = 3\n")
    straight, split = str(root / "straight"), str(root / "split")
    ranks = launch.start_ranks(_tools_rank, WORLD, (cfg, straight, split, cfg), threads=THREADS)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:  # while the ranks run: the single process's tools.test
        single = test_tool.main([cfg, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
        result = ranks.join()
    return dict(root=root, cfg=cfg, straight=straight, split=split, ranks=result, single=single)


def _check_resume_is_bitwise(tools_case):
    """(e): the resumed run's step-6 checkpoint equals the straight run's,
    parameters, BN buffers and AdamW moments (gathered from both ranks'
    ZeRO shards)."""
    for r in tools_case["ranks"]:
        assert r["iter"] == 6 and r["epoch"] == 3
    vals = []
    for work in (tools_case["straight"], tools_case["split"]):
        with open(os.path.join(work, "metrics.jsonl")) as f:
            vals.append([r for r in map(json.loads, f) if "coco/bbox_mAP" in r])
    assert len(vals[0]) == len(vals[1]) == 1 and vals[0][0]["val/num_dets"] > 0
    assert all(vals[0][0][k] == v or (math.isnan(v) and math.isnan(vals[0][0][k]))
               for k, v in vals[1][0].items())
    a = load_train_checkpoint(os.path.join(tools_case["straight"], "ckpts", "step_6"))
    b = load_train_checkpoint(os.path.join(tools_case["split"], "ckpts", "step_6"))
    assert a["step"] == b["step"] == 6
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(a["optimizer"]["adamw"]
                                                     ["param_groups"][0]["params"])
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def _check_resume_at_world1(tools_case):
    """(e): the world-2 step-4 checkpoint, resumed by one process (two steps
    an epoch become four): the model and the moments are the file's, and
    it trains on from step 4."""
    from rsprompter_tpu_torch.tools import train as train_tool

    work = str(tools_case["root"] / "world1")
    shutil.copytree(os.path.join(tools_case["straight"], "ckpts", "step_4"),
                    os.path.join(work, "ckpts", "step_4"))
    saved = load_train_checkpoint(os.path.join(work, "ckpts", "step_4"))
    runner = train_tool.main([tools_case["cfg"], "--work-dir", work, "--device", "cpu",
                              "--resume", "--cfg-options", "max_epochs=2"])
    assert runner.trainer.iter == 8 and len(runner.train_loader) == 4
    first = load_train_checkpoint(os.path.join(work, "ckpts", "step_8"))
    assert first["optimizer"]["count"] == 8
    moved = sum(not torch.equal(first["model"][k], saved["model"][k]) for k in saved["model"])
    assert moved > 100
    fresh = build_trainer(dict(model=dict(runner.trainer.cfg["model"])), device="cpu", seed=1)
    fresh.load_state_dict(saved)
    adam = fresh.optimizer.adamw.state
    for i, (_, p) in enumerate(fresh.optimizer.trained):
        assert torch.equal(adam[p]["exp_avg"], saved["optimizer"]["adamw"]["state"][i]
                           ["exp_avg"]), i


def _check_test_tool(tools_case):
    """(f): five images over two ranks (three and two) against one process:
    the metrics to 1e-6, the digest's sums, and five images counted."""
    single = tools_case["single"]
    assert single["timing"]["images"] == N_TEST
    for r in tools_case["ranks"]:
        assert r["images"] == N_TEST
        assert r["metrics"].keys() == single["metrics"].keys()
        for k, v in single["metrics"].items():
            got = r["metrics"][k]
            assert (math.isnan(v) and math.isnan(got)) or abs(got - v) <= METRIC_TOL, k
        assert r["digest"]["val/num_dets"] == single["digest"]["val/num_dets"] > 0
        for k, v in single["digest"].items():
            assert abs(r["digest"][k] - v) <= METRIC_TOL, k
    a, b = (r["metrics"] for r in tools_case["ranks"])
    assert all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)
