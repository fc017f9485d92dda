"""The port's analysis tools (``rsprompter_tpu_torch/tools/analysis_tools/``)
and profiling helpers on the CPU, against the JAX package's tools where
those run without a device.

Each tool's ``main`` runs on a ``utils.synthetic.synthetic_coco`` set in a
temporary directory, with the tiny RSPrompter-anchor of
``test_torch_eval.py`` and ``--device cpu`` where the tool takes a device:

- ``test_robustness``: the clean run and 2 corruptions x 1 severity, each a
  ``tools.test`` process; the JSON holds JAX's keys and P / mPC / rPC
  follow from the runs (also on planted values).
- ``eval_metric``, ``coco_error_analysis``, ``analyze_results``,
  ``fuse_results`` on a ``tools.test --out`` dump with GT planted among the
  detections (random weights find nothing): every number equals the JAX
  tool's on the same dump; ``eval_metric`` equals what ``tools.test``
  printed; the waterfall of a hand-made dump sits where JAX's test puts it;
  ``analyze_results`` ranks as JAX does and writes JPEGs.
- ``confusion_matrix``: ``accumulate`` equals JAX's on seeded boxes;
  ``main`` counts every GT once in its row.
- ``browse_dataset`` (raw and ``--pipeline``), ``optimize_anchors`` (its
  k-means recovers known clusters and equals JAX's; ``main`` on the set),
  ``analyze_logs`` on a log the port's ``LocalVisBackend`` writes (its
  series equal JAX's), ``benchmark`` (inference, dataloader, dataset).
- ``get_flops``: the count of a tiny SAM encoder equals the analytic sum of
  its products and convolutions; ``main`` prints for predict and loss.
- ``utils.testing.demo_batch``: JAX's ground truth from the same seed, its
  images mapped to uint8.
- ``engine.profiling``: the NaN hooks name the first module whose output is
  not finite, and come off again; ``StepTimer`` equals JAX's on the same
  clock; ``trace`` writes a Chrome trace; ``device_memory_stats`` is empty
  without a card.
"""

import importlib.util
import json
import math
import os
import pathlib
import time

import cv2
import numpy as np
import pytest
import torch

from rsprompter_tpu_torch.data.io import imread
from rsprompter_tpu_torch.engine import profiling
from rsprompter_tpu_torch.engine.vis_backend import LocalVisBackend
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.tools import test as test_tool
from rsprompter_tpu_torch.tools.analysis_tools import (
    analyze_logs, analyze_results, benchmark, browse_dataset, coco_error_analysis,
    confusion_matrix, eval_metric, fuse_results, get_flops, optimize_anchors, test_robustness)
from rsprompter_tpu_torch.utils.synthetic import synthetic_coco
from test_torch_eval import CLASSES, TINY_MODEL

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_tool(name):
    """The JAX package's tool module, loaded from its file (its device work
    is imported inside its functions)."""
    path = ROOT / "tools" / "analysis_tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic set, a config with train and test loaders over it, and a
    ``tools.test --out`` dump with GT planted among the detections."""
    tmp = tmp_path_factory.mktemp("tools")
    coco = synthetic_coco(str(tmp / "coco"), CLASSES, ((64, 80), (70, 64), (64, 64), (60, 90)),
                          cv2.imwrite)
    ds = dict(type="NWPUInsSegDataset", data_root=coco, ann_file="ann.json",
              data_prefix=dict(img="imgs"))
    cfg = tmp / "tiny.py"
    cfg.write_text(
        f"model = {TINY_MODEL!r}\ncrop_size = (64, 64)\n"
        f"train_dataloader = dict(batch_size=2, dataset={ds!r})\n"
        f"val_dataloader = dict(batch_size=2, dataset=dict({ds!r}, test_mode=True))\n"
        "test_dataloader = val_dataloader\n")
    raw = tmp / "raw.json"
    report = test_tool.main([str(cfg), "--device", "cpu", "--out", str(raw)])
    dump = json.loads(raw.read_text())
    rng = np.random.default_rng(0)
    for rec in dump["images"]:
        gt, det = rec["gt"], rec["det"]
        for j, (box, label, crowd) in enumerate(zip(gt["bboxes"], gt["labels"], gt["iscrowd"])):
            if crowd or j % 3 == 2:  # some GT stays unfound
                continue
            det["bboxes"].insert(0, list(np.asarray(box) + rng.uniform(-1.5, 1.5, 4)))
            det["scores"].insert(0, float(rng.uniform(0.2, 1.0)))
            det["labels"].insert(0, label)
            det["masks"].insert(0, gt["masks"][j])
    planted = tmp / "planted.json"
    planted.write_text(json.dumps(dump))
    return dict(tmp=tmp, cfg=str(cfg), raw=str(raw), planted=str(planted), report=report,
                dump=dump)


def test_robustness_protocol(setup, tmp_path, capsys):
    out = tmp_path / "rob.json"
    res = test_robustness.main([setup["cfg"], "--corruptions", "gaussian_noise",
                                "jpeg_compression", "--severities", "2", "--device", "cpu",
                                "--out", str(out)])
    assert json.loads(out.read_text()).keys() == {"clean", "per_corruption", "mPC", "rPC"}
    assert res["clean"] == setup["report"]["metrics"]["coco/bbox_mAP"]
    assert {k: len(v) for k, v in res["per_corruption"].items()} == {
        "gaussian_noise": 1, "jpeg_compression": 1}
    assert res["mPC"] == np.mean([v[0] for v in res["per_corruption"].values()])
    assert "P (clean)" in capsys.readouterr().out


def test_robustness_summary(monkeypatch):
    """P, mPC and rPC from planted per-run APs, as JAX's summary forms them."""
    aps = iter([0.5, 0.4, 0.2, 0.3, 0.1])
    monkeypatch.setattr(test_robustness, "run_eval", lambda *a, **k: next(aps))
    res = test_robustness.main(["cfg.py", "--corruptions", "brightness", "pixelate",
                                "--severities", "1", "5", "--device", "cpu"])
    assert res["clean"] == 0.5 and res["per_corruption"] == {"brightness": [0.4, 0.2],
                                                             "pixelate": [0.3, 0.1]}
    assert math.isclose(res["mPC"], 0.25) and math.isclose(res["rPC"], 0.5)


def test_eval_metric_matches_tool_and_jax(setup, capsys):
    ours = eval_metric.evaluate_dump(setup["raw"])
    for k, v in setup["report"]["metrics"].items():
        assert (math.isnan(v) and math.isnan(ours[k])) or ours[k] == v, k
    jax_eval = _jax_tool("eval_metric")
    for path in (setup["raw"], setup["planted"]):
        got = eval_metric.main([path, "--classwise"])
        ref = jax_eval.evaluate_dump(path, classwise=True)
        assert got.keys() == ref.keys()
        for k in ref:
            assert (math.isnan(ref[k]) and math.isnan(got[k])) or got[k] == ref[k], k
    planted = eval_metric.evaluate_dump(setup["planted"])
    assert 0 < planted["coco/bbox_mAP"] < 1 and 0 < planted["coco/segm_mAP"] < 1
    assert "coco/segm_mAP:" in capsys.readouterr().out


def test_coco_error_analysis_matches_jax(setup, tmp_path):
    jax_cea = _jax_tool("coco_error_analysis")
    for metric in ("bbox", "segm"):
        got = coco_error_analysis.main([setup["planted"], "--metric", metric,
                                        "--out", str(tmp_path / f"{metric}.png")])
        ref = jax_cea.analyze_dump(setup["planted"], metric)
        assert got.keys() == ref.keys() and len(got) > 0
        for c in ref:
            for s in coco_error_analysis.STAGES:
                assert (math.isnan(ref[c][s]) and math.isnan(got[c][s])) or \
                    got[c][s] == ref[c][s], (metric, c, s)
    # JAX's hand-made waterfall: a localisation-imprecise TP beside a
    # higher-scored class confusion
    dump = {"num_classes": 2, "metrics": ["bbox"], "images": [{
        "det": {"bboxes": [[100, 100, 140, 140], [4, 4, 44, 44]], "scores": [0.9, 0.8],
                "labels": [0, 0]},
        "gt": {"bboxes": [[0, 0, 40, 40], [100, 100, 140, 140]], "labels": [0, 1],
               "iscrowd": [False, False], "areas": [1600.0, 1600.0]}}]}
    path = tmp_path / "w.json"
    path.write_text(json.dumps(dump))
    row = coco_error_analysis.analyze_dump(str(path))[0]
    assert row["C75"] == 0.0 and 0.4 < row["C50"] <= 0.6 and row["Loc"] == row["C50"]
    assert row["Oth"] == row["BG"] == row["FN"] == 1.0


def test_analyze_results_ranks_as_jax(setup, tmp_path):
    jax_ar = _jax_tool("analyze_results")
    ours = analyze_results.per_image_ap(setup["dump"])
    ref = jax_ar.per_image_ap(setup["dump"])
    assert [a for a, _ in ours] == [a for a, _ in ref] or all(
        (math.isnan(x) and math.isnan(y)) or x == y for (x, _), (y, _) in zip(ours, ref))
    planted = json.loads(pathlib.Path(setup["planted"]).read_text())
    written = analyze_results.main([setup["planted"], "--out-dir", str(tmp_path), "--topk",
                                    "1"])
    scored = sorted((a, r) for a, r in ((a, r["meta"]["img_id"])
                                        for a, r in analyze_results.per_image_ap(planted))
                    if not math.isnan(a))
    assert written["bad"][0].endswith(f"_{scored[0][0]:.3f}.jpg")
    assert written["good"][0].endswith(f"_{scored[-1][0]:.3f}.jpg")
    for group in ("good", "bad"):
        name = written[group][0]
        img = imread(str(tmp_path / group / name))
        src = imread(os.path.join(setup["tmp"], "coco", "imgs", name.split("_")[0] + ".png"))
        assert img.shape == src.shape


def test_fuse_results(setup, tmp_path):
    """Two dumps with opposite localisation bias fuse nearer the GT (JAX's
    test), and the fused dump equals JAX's fusion of the same inputs."""
    gt_box, shift = [40.0, 40.0, 80.0, 80.0], 4.0

    def dump_for(offset):
        return {"num_classes": 1, "metrics": ["bbox"], "images": [{
            "det": {"bboxes": [[40 + offset, 40, 80 + offset, 80]], "scores": [0.8],
                    "labels": [0]},
            "gt": {"bboxes": [gt_box], "labels": [0], "iscrowd": [False], "areas": [1600.0]}}]}

    pa, pb, out = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "f.json"
    pa.write_text(json.dumps(dump_for(-shift)))
    pb.write_text(json.dumps(dump_for(shift)))
    fused = fuse_results.main([str(pa), str(pb), "--out", str(out)])
    assert fused["coco/bbox_mAP"] == 1.0 > eval_metric.evaluate_dump(str(pa))["coco/bbox_mAP"]
    jax_fuse = _jax_tool("fuse_results")
    for paths in ([str(pa), str(pb)], [setup["planted"], setup["raw"]]):
        assert fuse_results.fuse_dumps(paths) == json.loads(json.dumps(
            jax_fuse.fuse_dumps(paths)))


def test_confusion_matrix(setup, tmp_path):
    jax_cm = _jax_tool("confusion_matrix")
    rng = np.random.default_rng(0)
    for _ in range(20):
        g, p = rng.integers(0, 6, 2)
        gt = np.sort(rng.uniform(0, 60, (g, 2, 2)), axis=1).reshape(g, 4)
        pred = np.sort(rng.uniform(0, 60, (p, 2, 2)), axis=1).reshape(p, 4)
        pred[: min(g, p)] = gt[: min(g, p)] + rng.uniform(-3, 3, (min(g, p), 4))
        args = (pred, rng.integers(0, 3, p), rng.uniform(0, 1, p), gt, rng.integers(0, 3, g),
                0.3, 0.5)
        ours, ref = np.zeros((4, 4), np.int64), np.zeros((4, 4), np.int64)
        confusion_matrix.accumulate(ours, *args)
        jax_cm.accumulate(ref, *args)
        np.testing.assert_array_equal(ours, ref)
    cm = confusion_matrix.main([setup["cfg"], "--device", "cpu", "--score-thr", "0.0",
                                "--out-dir", str(tmp_path)])
    n_gt = sum(len(r["gt"]["labels"]) for r in setup["dump"]["images"])
    assert cm.shape == (len(CLASSES) + 1,) * 2
    assert cm[: len(CLASSES)].sum() >= n_gt  # every GT counted in its row at least once
    np.testing.assert_array_equal(np.load(tmp_path / "confusion_matrix.npy"), cm)


def test_browse_dataset(setup, tmp_path):
    names = browse_dataset.main([setup["cfg"], "--output-dir", str(tmp_path / "raw"),
                                 "--phase", "val", "--max-samples", "3"])
    assert names == ["000.png", "001.png", "002.png"]
    for name in names:
        src = imread(os.path.join(setup["tmp"], "coco", "imgs", name))
        assert imread(str(tmp_path / "raw" / name)).shape == src.shape
    piped = browse_dataset.main([setup["cfg"], "--output-dir", str(tmp_path / "p"),
                                 "--pipeline", "--max-samples", "4"])
    assert piped  # the random crop keeps at most the crop size of each image
    for name in piped:
        h, w = imread(str(tmp_path / "p" / name)).shape[:2]
        assert h <= 64 and w <= 64


def test_optimize_anchors(setup):
    rs = np.random.RandomState(0)
    wh = np.concatenate([np.array([20.0, 40.0]) + rs.randn(50, 2),
                         np.array([100.0, 60.0]) + rs.randn(50, 2)])
    anchors, miou = optimize_anchors.kmeans_anchors(wh, 2, seed=1)
    assert miou > 0.95
    assert np.allclose(anchors[0], [20, 40], atol=2) and np.allclose(anchors[1], [100, 60],
                                                                         atol=2)
    jax_oa = _jax_tool("optimize_anchors")
    wh = np.abs(rs.randn(300, 2)) * 30 + 2
    ref = jax_oa.kmeans_anchors(wh, 5, seed=3)
    got = optimize_anchors.kmeans_anchors(wh, 5, seed=3)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]
    out = optimize_anchors.main([setup["cfg"], "--k", "3"])
    assert out["anchors"].shape == (3, 2) and 0 < out["mean_iou"] <= 1 and out["boxes"] > 3


def test_analyze_logs(tmp_path, capsys):
    backend = LocalVisBackend(str(tmp_path))
    rows = [(0, 2, 2.0, 0.1), (0, 4, 1.5, 2.0), (1, 6, 1.0, 2.0), (1, 8, 0.5, 2.5)]
    for epoch, it, loss, rate in rows[:2]:
        backend.log_scalars(dict(epoch=epoch, iter=it, loss=loss, it_per_s=rate, lr=1e-4),
                            step=it)
    backend.log_scalars({"epoch": 0, "coco/bbox_mAP": 0.1})
    for epoch, it, loss, rate in rows[2:]:
        backend.log_scalars(dict(epoch=epoch, iter=it, loss=loss, it_per_s=rate, lr=1e-4),
                            step=it)
    backend.log_scalars({"epoch": 1, "coco/bbox_mAP": 0.3})
    log = str(tmp_path / "metrics.jsonl")
    jax_logs = _jax_tool("analyze_logs")
    records = analyze_logs.load_log(log)
    assert records == jax_logs.load_log(log)
    for key in ("loss", "coco/bbox_mAP"):
        for a, b in zip(analyze_logs.series_for_key(records, key),
                        jax_logs.series_for_key(records, key)):
            np.testing.assert_array_equal(a, b)
    analyze_logs.main(["cal_train_time", log])
    assert "average iter time: 0.4500 s/iter" in capsys.readouterr().out
    analyze_logs.main(["plot_curve", log, "--keys", "loss", "coco/bbox_mAP", "--out",
                       str(tmp_path / "c.png")])
    out = capsys.readouterr().out
    assert "saved" in out or "epoch" in out


def test_benchmark(setup, capsys):
    res = benchmark.main([setup["cfg"], "--task", "inference", "--repeat", "1", "--device",
                          "cpu"])
    assert res["images_per_s"] > 0 and res["device"] == "cpu"
    assert benchmark.main([setup["cfg"], "--task", "dataloader", "--repeat", "2"])[
        "images_per_s"] > 0
    assert benchmark.main([setup["cfg"], "--task", "dataset", "--repeat", "2"])[
        "images_per_s"] > 0
    assert "inference:" in capsys.readouterr().out


def _encoder_flops(cfg: SamVisionConfig, b: int) -> int:
    """The products and convolutions of the encoder, by hand."""
    c, p, nh, m = cfg.hidden_size, cfg.patch_size, cfg.num_attention_heads, cfg.mlp_dim
    g = cfg.image_size // p
    d, t = c // nh, b * g * g
    total = 2 * t * c * 3 * p * p  # patch embedding
    for i in range(cfg.num_hidden_layers):
        if i in cfg.global_attn_indexes:
            n, hw = b, (g, g)
        else:
            w = cfg.window_size
            n, hw = b * (-(-g // w)) ** 2, (w, w)  # zero-padded windows
        s = hw[0] * hw[1]
        total += 2 * n * s * c * 3 * c  # qkv
        total += 2 * n * nh * s * (hw[0] + hw[1]) * d  # rel-pos factors
        total += 2 * 2 * n * nh * s * s * d  # q k^T and P v
        total += 2 * n * s * c * c  # proj
        total += 2 * 2 * t * c * m  # fc1, fc2
    co = cfg.output_channels
    return total + 2 * t * c * co + 2 * t * co * co * 9  # the neck


def test_get_flops_counts_products(setup, capsys):
    cfg = SamVisionConfig(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                          global_attn_indexes=(1,), image_size=64, patch_size=8,
                          window_size=3, output_channels=16)
    enc = SamVisionEncoder(cfg).eval()
    pixels = torch.randn(2, 64, 64, 3)  # NHWC, as the detector feeds it
    with torch.no_grad():
        got = get_flops.count_flops(enc, pixels)
    assert got == _encoder_flops(cfg, 2)
    for mode in ("predict", "loss"):
        res = get_flops.main([setup["cfg"], "--mode", mode, "--device", "cpu"])
        assert res["flops"] > 0 and res["params"] > 0
    out = capsys.readouterr().out
    assert "GFLOPs (products and convolutions only" in out and "params:" in out
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_flops.main([setup["cfg"]])


@pytest.mark.parametrize("num_gts", [None, (3, 0, 5)])
def test_demo_batch_matches_jax(num_gts):
    from rsprompter_tpu.utils.testing import demo_batch as jax_demo_batch
    from rsprompter_tpu_torch.utils.testing import demo_batch

    kw = dict(batch_size=3, image_size=(48, 40), max_gt=4, num_classes=3, num_gts=num_gts,
              seed=5)
    ours, ref = demo_batch(device="cpu", **kw), jax_demo_batch(**kw)
    assert ours.keys() == ref.keys()
    for k in ref:
        if k == "images":
            want = np.clip(np.round(128 + 64 * ref[k]), 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(ours[k].numpy(), want)
        else:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    assert ours["images"].dtype == torch.uint8 and ours["gt_labels"].dtype == torch.int64


def test_nan_checks_name_the_module():
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 2))
    with torch.no_grad():
        model[2].weight[0, 0] = float("nan")
    profiling.enable_nan_checks(model)
    try:
        with pytest.raises(FloatingPointError, match=r"non-finite output of 2 \(Linear\)"):
            model(torch.ones(3, 4))
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_checks(model, False)
    assert not torch.is_anomaly_enabled()
    assert not torch.isfinite(model(torch.ones(3, 4))).all()  # hooks off: no raise


def test_step_timer_matches_jax(monkeypatch):
    from rsprompter_tpu.engine import profiling as jax_profiling

    clock = iter(np.cumsum([0.0, 0.5, 0.25, 0.25, 0.1, 0.4, 0.3]).tolist() * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, ref = profiling.StepTimer(window=3, warmup=2), jax_profiling.StepTimer(window=3,
                                                                                 warmup=2)
    for timer in (ours, ref):
        assert timer.steps_per_sec == 0.0
        for _ in range(7):
            timer.tick()
    assert ours.steps_per_sec == ref.steps_per_sec == 3 / 0.8


def test_trace_and_memory_stats(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
