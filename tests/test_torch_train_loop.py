"""The port's training loop held against the JAX package on the CPU.

- ``resize_masks_nearest``: pixel-equal to ``cv2.INTER_NEAREST`` over many
  size pairs (the index rule the port derives, not OpenCV's code).
- The train pipeline (``RandomFlip``, ``RandomResize``, ``RandomCrop``,
  ``FilterAnnotations``, ``PackDetInputs``) and the test pipeline
  (``Resize``, ``Pad``, ``PackDetInputs``), transform by transform and
  whole, one seeded ``RandomState`` per package, hypothesis over sizes and
  seeds: every field equal but the image, which may differ by one level
  after rounding on at most 1e-3 of its values (the port's OpenCV-exact
  float resize, ``tests/test_torch_resize.py``). The share is held on
  images of 200 to 700 pixels a side, as the data's are; where a resize
  coefficient rounds differently from OpenCV's the mismatches fill a whole
  row or column, so on images of 8 to 160 pixels (where every other field
  is held equal too) the image is held to the one level alone.
- ``collate_batch`` (``gt_masks_packed`` included) and ``unpack_batch_masks``
  equal to JAX's; the train loader's batches over two epochs, with shards,
  ``drop_last`` and prefetch, and its length, equal to JAX's loader's.
- ``accumulate_steps=2`` against ``optax.MultiSteps`` (JAX's
  ``build_optimizer``): parameters and Adam moments within 1e-6.
- Checkpoints: save, latest, prune, restore; resume through
  ``tools.train --resume`` bitwise equal to an uninterrupted run (every
  parameter, moment and BN buffer) on a tiny detector (hidden 32, 64^2, two
  layers, as ``tests/test_runner.py``).
- ``tools.train`` end to end on a synthetic COCO set: ``metrics.jsonl``
  holds JAX's record keys with ``lr`` equal to JAX's
  ``warmup_cosine_schedule`` at ``iter`` (1e-6 relative: fp32 in optax,
  float64 here), the ``coco/*`` and ``val/*`` keys; ``ckpts/`` pruned to
  JAX's ``keep`` of 5; both ``best_*`` directories; and ``tools.test`` on the
  last checkpoint gives the last validation's keys exactly (fp32, the same
  module state). A mismatched ``num_classes``, ``dist.enable`` without a
  launcher and ``dist.model_parallel`` > 1 raise.
- ``Runner.validate`` with ``vis_interval``: JAX's ``vis/val_{offset}.jpg``
  drawings at the images' sizes, the metrics unchanged; a drawing that
  cannot read its file is logged, any other error propagates.

JAX's references here are its numpy / cv2 transforms, its loader and optax:
no JAX model is compiled.
"""

import copy
import json
import math
import os
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rsprompter_tpu.data import transforms as jt
from rsprompter_tpu.data.loader import DataLoader as JaxDataLoader
from rsprompter_tpu.engine.optim import build_optimizer as jax_build_optimizer
from rsprompter_tpu.engine.optim import warmup_cosine_schedule as jax_schedule
from rsprompter_tpu.ops.masks import unpack_batch_masks as jax_unpack_batch_masks
from rsprompter_tpu_torch.data import transforms as tt
from rsprompter_tpu_torch.data.loader import TrainLoader
from rsprompter_tpu_torch.engine.checkpoint import (
    CKPT_FILE, latest_checkpoint, load_train_checkpoint, restore_checkpoint, save_checkpoint)
from rsprompter_tpu_torch.engine.optim import build_optimizer
from rsprompter_tpu_torch.engine.runner import Runner
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.ops.masks import unpack_batch_masks
from rsprompter_tpu_torch.tools import test as test_tool
from rsprompter_tpu_torch.tools import train as train_tool
from rsprompter_tpu_torch.utils.synthetic import synthetic_coco

IMAGE_LEVELS = 1  # the image may differ by one level after rounding ...
IMAGE_SHARE = 1e-3  # ... on at most this share of its values
MULTISTEPS_TOL = 1e-6
LR_TOL = 1e-6  # relative: optax's fp32 schedule against the port's float64
CLASSES = ("plane", "ship", "tank")
HYPOTHESIS = settings(max_examples=10, deadline=None, derandomize=True, database=None)


# --- the pipeline, transform by transform -----------------------------------


def _raw_sample(seed, h, w, n_obj):
    """A ``load_raw``-shaped sample: uint8 BGR image, box / mask GT."""
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    masks, boxes = [], []
    for _ in range(n_obj):
        cx, cy = rs.uniform(0, w), rs.uniform(0, h)
        rx, ry = rs.uniform(1, w / 3), rs.uniform(1, h / 3)
        m = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1).astype(np.uint8)
        m[int(cy) % h, int(cx) % w] = 1
        ys, xs = np.nonzero(m)
        masks.append(m)
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    return dict(
        img=img, img_id=seed, img_path=f"{seed}.png", ori_shape=(h, w), img_shape=(h, w),
        scale_factor=(1.0, 1.0),
        gt_bboxes=np.asarray(boxes, np.float32).reshape(n_obj, 4),
        gt_labels=rs.randint(0, len(CLASSES), n_obj).astype(np.int64),
        gt_ignore_flags=rs.rand(n_obj) < 0.2,
        gt_areas=np.asarray([m.sum() for m in masks], np.float64),
        gt_masks=np.stack(masks) if masks else np.zeros((0, h, w), np.uint8),
    )


def _as_u8(img):
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def assert_image_close(got, ref, share=IMAGE_SHARE):
    assert got.shape == ref.shape
    diff = np.abs(_as_u8(got).astype(np.int16) - _as_u8(ref).astype(np.int16))
    assert diff.max(initial=0) <= IMAGE_LEVELS
    if share is not None:
        assert (diff > 0).mean() <= share


def assert_sample_equal(got, ref, share=IMAGE_SHARE):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "img":
            assert_image_close(got[k], ref[k], share)
        elif isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            assert np.array_equal(got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k


def _run_both(port_pipeline, jax_pipeline, sample, share=IMAGE_SHARE):
    """Step both pipelines side by side, comparing after every transform;
    returns the two outputs."""
    got = copy.deepcopy(sample)
    ref = copy.deepcopy(sample)
    ref["img"] = ref["img"].astype(np.float32)  # JAX decodes to float32
    for pt, jtf in zip(port_pipeline, jax_pipeline):
        got, ref = pt(got), jtf(ref)
        assert_sample_equal(got, ref, share)
        if ref is None:
            break
    return got, ref


SMALL = dict(h=st.integers(8, 160), w=st.integers(8, 160),
             crop=st.sampled_from([(32, 32), (64, 64), (48, 80)]), share=st.just(None))
DATA_SIZED = dict(h=st.integers(200, 700), w=st.integers(200, 700),
                  crop=st.sampled_from([(256, 256), (384, 512)]), share=st.just(IMAGE_SHARE))


@pytest.mark.parametrize("sizes", [SMALL, DATA_SIZED], ids=["small", "data_sized"])
def test_train_pipeline_matches_jax(sizes):
    @HYPOTHESIS
    @given(seed=st.integers(0, 2 ** 31 - 1), n_obj=st.integers(0, 5), **sizes)
    def check(seed, h, w, crop, share, n_obj):
        sample = _raw_sample(seed, h, w, n_obj)
        got, ref = _run_both(tt.build_train_pipeline(crop, rng=np.random.RandomState(seed)),
                             jt.build_train_pipeline(crop, rng=np.random.RandomState(seed)),
                             sample, share)
        assert got["img"].dtype == np.uint8 and ref["img"].dtype == np.uint8

    check()


@pytest.mark.parametrize("sizes", [SMALL, DATA_SIZED], ids=["small", "data_sized"])
def test_test_pipeline_and_negative_crop_match_jax(sizes):
    @HYPOTHESIS
    @given(seed=st.integers(0, 2 ** 31 - 1), n_obj=st.integers(0, 5), **sizes)
    def check(seed, h, w, crop, share, n_obj):
        sample = _raw_sample(seed, h, w, n_obj)
        _run_both(tt.build_test_pipeline(crop), jt.build_test_pipeline(crop), sample, share)
        # a crop that may keep no GT returns None in both
        _run_both([tt.RandomCrop(crop, allow_negative_crop=False,
                                 rng=np.random.RandomState(seed))],
                  [jt.RandomCrop(crop, allow_negative_crop=False,
                                 rng=np.random.RandomState(seed))], sample, share)

    check()


def test_nearest_resize_matches_cv2():
    rs = np.random.RandomState(0)
    sizes = list(range(1, 40)) + [63, 64, 65, 97, 128, 255, 256, 257, 511, 512, 513, 700,
                                  1000, 1023, 1024, 1025, 2048]
    n = 0
    for h_in in (1, 2, 7, 64, 513, 1000):
        for w_in in sizes:
            for _ in range(3):
                h_out, w_out = int(rs.choice(sizes)), int(rs.choice(sizes))
                m = (rs.rand(2, h_in, w_in) > 0.5).astype(np.uint8)
                ref = np.stack([cv2.resize(x, (w_out, h_out), interpolation=cv2.INTER_NEAREST)
                                for x in m])
                assert np.array_equal(tt.resize_masks_nearest(m, h_out, w_out), ref), (
                    h_in, w_in, h_out, w_out)
                n += 1
    assert n == 6 * len(sizes) * 3


# --- collate, unpack, loader ------------------------------------------------


def test_collate_and_unpack_match_jax():
    pipeline = tt.build_train_pipeline((48, 64), rng=np.random.RandomState(3))
    samples = []
    for i, (h, w) in enumerate(((50, 70), (90, 40), (30, 30))):
        s = _raw_sample(10 + i, h, w, 4)
        for t in pipeline:
            s = t(s)
        samples.append(s)
    for kw in (dict(batch_size=4, max_gt=3, pad_shape=(48, 64)), dict(max_gt=8),
               dict(batch_size=3, max_gt=5, pad_shape=(64, 64), pack_masks=False)):
        got, got_metas = tt.collate_batch(copy.deepcopy(samples), **kw)
        ref, ref_metas = jt.collate_batch(copy.deepcopy(samples), **kw)
        assert got.keys() == ref.keys() and got_metas == ref_metas
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
        if "gt_masks_packed" in got:
            port = unpack_batch_masks({k: torch.from_numpy(v) for k, v in got.items()})
            jax_out = jax_unpack_batch_masks({k: jnp.asarray(v) for k, v in ref.items()})
            assert port.keys() == jax_out.keys()
            assert port["gt_masks"].dtype == torch.float32
            assert np.array_equal(port["gt_masks"].numpy(), np.asarray(jax_out["gt_masks"]))


class _Stub:
    """Samples that carry their index (img_id, pixel value, GT count)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        s = _raw_sample(i, 10 + i % 3, 12, i % 3)
        s["img"][:] = i
        return s


@pytest.mark.parametrize("n,bs,drop_last,shard_id,num_shards,seed,prefetch", [
    (11, 3, True, 0, 1, 0, 0), (11, 3, False, 0, 1, 5, 0), (10, 2, True, 1, 2, 1, 2),
    (13, 4, False, 2, 3, 2, 1), (3, 4, True, 0, 1, 0, 0),
])
def test_train_loader_matches_jax(n, bs, drop_last, shard_id, num_shards, seed, prefetch):
    kw = dict(batch_size=bs, shuffle=True, seed=seed, max_gt=4, pad_shape=(16, 16),
              drop_last=drop_last, shard_id=shard_id, num_shards=num_shards, prefetch=prefetch)
    port, ref = TrainLoader(_Stub(n), **kw), JaxDataLoader(_Stub(n), **kw)
    assert len(port) == len(ref)
    for epoch in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref), epoch
        for (gb, gm), (rb, rm) in zip(got, want):
            assert gm == rm
            for k in rb:
                assert np.array_equal(gb[k], rb[k]), k
        assert port.epoch == ref.epoch == epoch + 1


def test_train_loader_raises_the_threads_error():
    class Broken(_Stub):
        def __getitem__(self, i):
            raise OSError(f"cannot decode {i}")

    with pytest.raises(OSError, match="cannot decode"):
        list(TrainLoader(Broken(4), batch_size=2, prefetch=2))


# --- gradient accumulation ----------------------------------------------------


def test_accumulate_steps_matches_optax_multisteps():
    rs = np.random.RandomState(0)
    model = torch.nn.ModuleDict({"backbone": torch.nn.Linear(4, 3),
                                 "head": torch.nn.Linear(3, 2)})
    kw = dict(base_lr=5e-2, weight_decay=0.05, total_steps=6, warmup_steps=2,
              freeze_paths=["backbone"], grad_clip=0.5, accumulate_steps=2)
    opt = build_optimizer(model, **kw)
    params = {m: {k: jnp.asarray(p.detach().numpy()) for k, p in mod.named_parameters()}
              for m, mod in model.items()}
    tx, _ = jax_build_optimizer(params, **kw)
    state = tx.init(params)
    for i in range(9):  # four updates and a half-accumulated fifth
        grads = {m: {k: rs.randn(*v.shape).astype(np.float32) * (1 + 3 * (i % 2))
                     for k, v in sub.items()} for m, sub in params.items()}
        for name, p in model.named_parameters():
            m, k = name.split(".")
            p.grad = torch.from_numpy(grads[m][k].copy())
        opt.step()
        updates, state = tx.update(jax_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
        mu = optax.tree_utils.tree_get(state, "mu")
        nu = optax.tree_utils.tree_get(state, "nu")
        for name, p in model.named_parameters():
            m, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), params[m][k], atol=MULTISTEPS_TOL)
            if m == "head" and i >= 1:
                s = opt.adamw.state[p]
                np.testing.assert_allclose(s["exp_avg"].numpy(), mu[m][k], atol=MULTISTEPS_TOL)
                np.testing.assert_allclose(s["exp_avg_sq"].numpy(), nu[m][k],
                                           atol=MULTISTEPS_TOL)
        assert opt.count == (i + 1) // 2 and opt.mini_step == (i + 1) % 2
    assert not torch.equal(model["head"].weight, model["head"].weight * 0)


def jax_tree(grads):
    return {m: {k: jnp.asarray(v) for k, v in sub.items()} for m, sub in grads.items()}


# --- checkpoints, resume and the train tool -------------------------------------

TINY_MODEL = dict(
    type="RSPrompterAnchor", bf16=False, num_classes=len(CLASSES), prompt_shape=(10, 3),
    image_size=64, select_layers=(1, 2), aggregator_hidden=8,
    vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       global_attn_indexes=(1,), image_size=64, patch_size=8, window_size=4,
                       output_channels=32),
    rpn_strides=(2, 4, 8, 16, 32), roi_strides=(2, 4, 8, 16), num_samples=16,
    pos_fraction=0.25, train_backbone=True, decoder_freeze=False,
    train_cfg=dict(rpn=dict(num=16), rpn_proposal=dict(nms_pre=50, max_per_img=20,
                                                       pre_nms_total=60)),
    test_cfg=dict(rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
                  rcnn=dict(score_thr=0.0, nms_iou_thr=0.5, max_per_img=8, nms_pre=40)),
)
# JAX's runner record keys (engine/runner.py:164-177 with the anchor loss terms)
JAX_RECORD_KEYS = {"epoch", "iter", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
                   "acc", "loss_mask", "loss", "grad_norm", "it_per_s", "lr", "rss_mb"}
COCO_KEYS = {f"coco/{m}_mAP{s}" for m in ("bbox", "segm")
             for s in ("", "_50", "_75", "_s", "_m", "_l")}
DIGEST_KEYS = {"val/num_dets", "val/mean_score", "val/mean_mask_prob"}


@pytest.fixture()
def scratch(tmp_path):
    """``tmp_path``, emptied when the test ends: a train checkpoint of the
    tiny detector is 268 MB (22.9M fp32 parameters and their AdamW moments),
    and pytest keeps every test's directory until the session ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return synthetic_coco(str(tmp_path_factory.mktemp("coco")), CLASSES,
                          ((64, 80), (70, 64), (60, 90), (72, 66)), cv2.imwrite, seed=1)


def _write_config(tmp_path, coco_dir, train_images=2, **extra):
    ds = dict(type="NWPUInsSegDataset", data_root=str(coco_dir), ann_file="ann.json",
              data_prefix=dict(img="imgs"), metainfo=dict(classes=CLASSES))
    body = dict(crop_size=(64, 64), max_gt=8, base_lr=1e-3, warmup_iters=2, seed=3,
                log_interval=1, ckpt_interval=1, val_interval=100, max_epochs=3)
    body.update(extra)
    path = tmp_path / "tiny_train.py"
    path.write_text(
        f"model = {TINY_MODEL!r}\n" + "".join(f"{k} = {v!r}\n" for k, v in body.items())
        + f"train_dataloader = dict(batch_size=2, dataset=dict({ds!r}, "
          f"indices={train_images}))\n"
        + f"val_dataloader = dict(batch_size=2, dataset=dict({ds!r}, test_mode=True))\n"
        + "test_dataloader = val_dataloader\n")
    return str(path)


def _records(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_checkpoint_save_latest_prune_restore(scratch):
    cfg = dict(model=TINY_MODEL, max_epochs=2)
    trainer = build_trainer(cfg, device="cpu", seed=0)
    ckpts = str(scratch / "ckpts")
    assert latest_checkpoint(ckpts) is None
    for step in (1, 2, 10, 3):
        trainer.iter = step
        with torch.no_grad():
            next(trainer.model.parameters()).add_(1.0)
        path = save_checkpoint(ckpts, trainer, step, keep=2)
        assert os.path.isfile(os.path.join(path, CKPT_FILE))
    assert sorted(os.listdir(ckpts)) == ["step_10", "step_3"]
    assert latest_checkpoint(ckpts).endswith("step_10")
    fresh = build_trainer(cfg, device="cpu", seed=1)
    restore_checkpoint(os.path.join(ckpts, "step_3"), fresh)
    assert fresh.iter == 3
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    saved = load_train_checkpoint(os.path.join(ckpts, "step_3", CKPT_FILE))
    assert saved.keys() == {"model", "optimizer", "step"}


def test_resume_is_bitwise(coco_dir, scratch):
    """3 epochs of one step straight, against a fresh runner resumed with
    ``--resume`` from the straight run's step-2 checkpoint (what a run
    stopped after that save leaves) for the third: every parameter, BN
    buffer, moment and count equal."""
    cfg = _write_config(scratch, coco_dir)
    straight, split = str(scratch / "straight"), str(scratch / "split")
    train_tool.main([cfg, "--work-dir", straight, "--device", "cpu"])
    shutil.copytree(os.path.join(straight, "ckpts", "step_2"),
                    os.path.join(split, "ckpts", "step_2"))
    runner = train_tool.main([cfg, "--work-dir", split, "--device", "cpu", "--resume"])
    assert runner.trainer.iter == 3 and runner.train_loader.epoch == 3
    assert [r["iter"] for r in _records(split)] == [3]
    a = load_train_checkpoint(os.path.join(straight, "ckpts", "step_3"))
    b = load_train_checkpoint(os.path.join(split, "ckpts", "step_3"))
    assert a["step"] == b["step"] == 3
    assert a["model"].keys() == b["model"].keys()
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    assert any("running_mean" in k for k in a["model"])
    oa, ob = a["optimizer"], b["optimizer"]
    assert (oa["count"], oa["mini_step"]) == (ob["count"], ob["mini_step"]) == (3, 0)
    sa, sb = oa["adamw"]["state"], ob["adamw"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert _records(straight)[-1]["loss"] == _records(split)[-1]["loss"]


def test_train_tool_end_to_end(coco_dir, scratch, capsys):
    cfg = _write_config(scratch, coco_dir, max_epochs=6, val_interval=3)
    work = str(scratch / "work")
    runner = train_tool.main([cfg, "--work-dir", work, "--device", "cpu"])
    records = _records(work)
    train_recs = [r for r in records if "loss" in r]
    val_recs = [r for r in records if "coco/bbox_mAP" in r]
    assert [r["iter"] for r in train_recs] == [1, 2, 3, 4, 5, 6]
    schedule = jax_schedule(1e-3, 6, 2)
    for r in train_recs:
        assert r.keys() == JAX_RECORD_KEYS
        assert math.isfinite(r["loss"]) and r["rss_mb"] > 0 and r["it_per_s"] > 0
        assert abs(r["lr"] - float(schedule(r["iter"]))) <= LR_TOL * 1e-3, r["iter"]
    assert [r["epoch"] for r in val_recs] == [2, 5]
    for r in val_recs:
        assert r.keys() == {"epoch"} | COCO_KEYS | DIGEST_KEYS
        assert r["val/num_dets"] > 0
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == [
        f"step_{i}" for i in (2, 3, 4, 5, 6)]
    for tag in ("bbox_mAP", "segm_mAP"):
        assert len(os.listdir(os.path.join(work, f"best_{tag}"))) == 1
    assert runner.trainer.model.training

    report = test_tool.main([cfg, os.path.join(work, "ckpts", "step_6"), "--device", "cpu"])
    assert "loaded train checkpoint" in capsys.readouterr().out
    last = val_recs[-1]
    for k, v in dict(report["metrics"], **report["digest"]).items():
        assert (math.isnan(v) and math.isnan(last[k])) or v == last[k], k


@pytest.mark.parametrize("option,error", [
    ("model.num_classes=5", ValueError), ("dist.enable=True", RuntimeError),
    ("dist.model_parallel=2", NotImplementedError),
])
def test_train_tool_refuses(coco_dir, tmp_path, option, error):
    cfg = _write_config(tmp_path, coco_dir)
    with pytest.raises(error):
        train_tool.main([cfg, "--work-dir", str(tmp_path / "w"), "--device", "cpu",
                         "--cfg-options", option])


def _val_runner(cfg_path, work_dir, vis_interval):
    from rsprompter_tpu_torch.core.config import Config
    from rsprompter_tpu_torch.core.registry import DATASETS
    from rsprompter_tpu_torch.data.loader import DataLoader

    cfg = Config.fromfile(cfg_path)
    trainer = build_trainer(cfg, device="cpu", seed=0)
    val = DataLoader(DATASETS.build(dict(cfg["val_dataloader"]["dataset"])), batch_size=2)
    return Runner(trainer, None, val, work_dir=work_dir, num_classes=len(CLASSES),
                  vis_interval=vis_interval)


def test_validate_draws_vis_interval(coco_dir, scratch, capsys, monkeypatch):
    """``vis_interval`` 1: slot 0 of every batch is drawn over its file into
    ``vis/val_{offset}.jpg`` (JAX's ``_visualize``), a JPEG at the image's
    size; the metrics are those of a run that draws nothing. A drawing that
    cannot read its file is logged and validation goes on; any other error
    propagates."""
    from rsprompter_tpu_torch.apis import visualization
    from rsprompter_tpu_torch.data.io import imread
    from rsprompter_tpu_torch.engine import runner as runner_mod

    cfg = _write_config(scratch, coco_dir)
    work = scratch / "vis_run"
    drawn = _val_runner(cfg, str(work), 1).validate()
    plain = _val_runner(cfg, str(scratch / "plain"), 0).validate()
    for k, v in plain.items():
        assert (math.isnan(v) and math.isnan(drawn[k])) or drawn[k] == v, k
    assert sorted(os.listdir(work / "vis")) == ["val_0.jpg", "val_2.jpg"]
    for name, src in (("val_0.jpg", "000.png"), ("val_2.jpg", "002.png")):
        assert imread(str(work / "vis" / name)).shape == imread(
            os.path.join(coco_dir, "imgs", src)).shape
    assert not os.path.exists(scratch / "plain" / "vis")

    runner = _val_runner(cfg, str(scratch / "broken"), 2)
    real = runner_mod.draw_slot

    def unreadable(path, dets, probs, i, meta, *args):
        return real(path, dets, probs, i, dict(meta, img_path=str(scratch / "gone.png")),
                    *args)

    monkeypatch.setattr(runner_mod, "draw_slot", unreadable)
    assert runner.validate().keys() == plain.keys()
    assert "vis failed:" in capsys.readouterr().out

    def fails(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(runner_mod, "draw_slot", fails)
    with pytest.raises(RuntimeError, match="CUDA error"):
        runner.validate()
    assert visualization.draw_slot is real
