"""The WHU data path's tools against the JAX package's, and the SLURM launcher.

- ``tools.rsprompter.whu2coco`` (the port's, OpenCV hidden) writes the JAX
  tool's JSON text (``tools/rsprompter/whu2coco.py``, with OpenCV) and
  prints its lines, on a seeded tree of WHU-style TIFF tiles
  (``utils.synthetic.synthetic_whu``, one image without a mask); the
  chip phase's digests (``chip_smoke.WHU_JSON_SHA256``) are the JAX tool's.
- It skips a cut tile, as ``cv2.imread`` gives None, and stops on a valid
  one that OpenCV reads and the port does not (a JPEG-compressed TIFF, a
  progressive JPEG: ``NotDecoded``) rather than dropping it.
- ``tools.misc.print_config`` prints the JAX tool's text on
  ``rsprompter_anchor-whu.py`` (``_delete_``), ``samdet-nwpu.py`` and one
  config with ``--cfg-options``.
- ``tools/slurm_train.sh`` under a faked two-node SLURM job on this host
  (a fake ``scontrol`` on ``PATH``, one process a node, gloo, ``--device
  cpu``) trains one step of ``regress-nwpu-128.py``; both ranks' parameters
  are equal after it.
"""

import hashlib
import os
import runpy
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from rsprompter_tpu_torch.data import tiff
from rsprompter_tpu_torch.data.io import NotDecoded
from rsprompter_tpu_torch.tools.misc import print_config
from rsprompter_tpu_torch.tools.rsprompter import whu2coco
from rsprompter_tpu_torch.utils.synthetic import synthetic_coco, synthetic_whu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "rsprompter")


def _run_jax_tool(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")


def test_whu2coco_equals_jax_tool(tmp_path, monkeypatch, capsys):
    root = synthetic_whu(str(tmp_path / "whu"), seed=chip_smoke.WHU_SEED)
    jax_tool = os.path.join(ROOT, "tools", "rsprompter", "whu2coco.py")
    texts = {}
    for split in ("train", "test"):
        img_dir = os.path.join(root, "imgs", split, "image")
        mask_dir = os.path.join(root, "imgs", split, "label")
        ref_json, got_json = str(tmp_path / f"{split}_jax.json"), str(tmp_path / f"{split}.json")
        _run_jax_tool(jax_tool, [img_dir, mask_dir, ref_json], monkeypatch)
        ref_out = capsys.readouterr()
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)  # the card's machine has no OpenCV
            whu2coco.main([img_dir, mask_dir, got_json])
        got_out = capsys.readouterr()
        ref_text, got_text = open(ref_json).read(), open(got_json).read()
        assert got_text == ref_text
        assert got_out.out.replace(got_json, ref_json) == ref_out.out
        skips = [line for line in got_out.err.splitlines() if line.startswith("skip")]
        assert skips == (["skip tile_006.tif (missing image or mask)"] if split == "train"
                         else [])
        assert all(line in ref_out.err for line in skips)
        texts[split] = ref_text
    assert {k: hashlib.sha256(t.encode()).hexdigest() for k, t in texts.items()} == \
        chip_smoke.WHU_JSON_SHA256
    assert '"area": 4.0' not in texts["train"]  # the 4-pixel line: 2 points, dropped


def _refused_tile(form: str, img: np.ndarray) -> bytes:
    if form == "jpeg_tiff":  # Compression 7 in the header: libtiff decodes it, the port not
        return tiff.encode_tiff(img[:, :, ::-1], tiff.RGB, compression=7)
    import cv2

    ok, data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    return data.tobytes()


@pytest.mark.parametrize("form,what", [
    ("jpeg_tiff", r"b\.tif: Compression \(tag 259\) = 7 is not decoded"),
    ("progressive_jpeg", r"b\.tif: unsupported marker SOF2 \(progressive\)"),
])
def test_whu2coco_stops_on_a_tile_it_does_not_decode(form, what, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    mask = np.zeros((16, 16), np.uint8)
    mask[2:8, 3:9] = 255
    img_dir, mask_dir = tmp_path / "image", tmp_path / "label"
    img_dir.mkdir()
    mask_dir.mkdir()
    for name in ("a.tif", "b.tif"):
        (mask_dir / name).write_bytes(tiff.encode_tiff(mask, tiff.MIN_IS_BLACK))
    (img_dir / "a.tif").write_bytes(tiff.encode_tiff(img, tiff.RGB)[:40])  # cut in its strip
    (img_dir / "b.tif").write_bytes(_refused_tile(form, img))
    out = tmp_path / "out.json"
    monkeypatch.setitem(sys.modules, "cv2", None)  # the card's machine has no OpenCV
    with pytest.raises(NotDecoded, match=what):
        whu2coco.main([str(img_dir), str(mask_dir), str(out)])
    assert capsys.readouterr().err.splitlines() == ["skip a.tif (missing image or mask)"]
    assert not out.exists()


@pytest.mark.parametrize("config,options", [
    ("rsprompter_anchor-whu.py", []),
    ("samdet-nwpu.py", []),
    ("rsprompter_query-whu.py", ["model.num_queries=33", "train_dataloader.batch_size=4",
                                 "optim_wrapper.optimizer.lr=0.0003"]),
])
def test_print_config_equals_jax_tool(config, options, monkeypatch, capsys):
    path = os.path.join(CONFIGS, config)
    argv = [path] + (["--cfg-options", *options] if options else [])
    _run_jax_tool(os.path.join(ROOT, "tools", "misc", "print_config.py"), argv, monkeypatch)
    ref = capsys.readouterr().out
    print_config.main(argv)
    got = capsys.readouterr().out
    assert got == ref and ref.startswith("{")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_slurm_train_two_nodes_one_step(tmp_path):
    import cv2

    coco = synthetic_coco(str(tmp_path / "coco"), chip_smoke.NWPU_CLASSES,
                          ((64, 80), (70, 64)), cv2.imwrite, seed=4)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    scontrol = bin_dir / "scontrol"  # SLURM's host list, as `scontrol show hostnames` gives it
    scontrol.write_text('#!/bin/sh\n[ "$1 $2" = "show hostnames" ] || exit 1\n'
                        'printf "127.0.0.1\\n127.0.0.2\\n"\n')
    scontrol.chmod(0o755)
    opts = ["dist.enable=True", "max_epochs=1", "val_interval=100", "ckpt_interval=100",
            "train_dataloader.batch_size=1", "train_dataloader.dataset.indices=2",
            "train_dataloader.num_workers=0"]
    for split in ("train", "val"):
        opts += [f"{split}_dataloader.dataset.data_root={coco}",
                 f"{split}_dataloader.dataset.ann_file=ann.json",
                 f"{split}_dataloader.dataset.data_prefix.img=imgs"]
    dump = tmp_path / "params"
    dump.mkdir()
    port = _free_port()
    procs = []
    for node in (0, 1):
        env = dict(os.environ, SLURM_JOB_NODELIST="node[0-1]", SLURM_NNODES="2",
                   SLURM_NTASKS="2", SLURM_NODEID=str(node), SLURM_PROCID=str(node),
                   GPUS_PER_NODE="1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PATH=f"{bin_dir}:{os.environ['PATH']}",
                   PYTHONPATH=os.path.join(ROOT, "tests"), TRAIN_MODULE="torch_slurm_rank",
                   RSP_PARAM_DUMP=str(dump))
        for key in ("MASTER_ADDR", "NNODES", "NODE_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            ["bash", os.path.join(ROOT, "rsprompter_tpu_torch", "tools", "slurm_train.sh"),
             os.path.join(CONFIGS, "regress-nwpu-128.py"), "--device", "cpu",
             "--work-dir", str(tmp_path / f"work{node}"), "--cfg-options", *opts],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert "node 1 of 2, 1 rank(s), rendezvous at 127.0.0.1" in outs[1]
    ranks = [torch.load(dump / f"rank{r}.pt") for r in (0, 1)]
    assert ranks[0]["iter"] == ranks[1]["iter"] == 1 and ranks[0]["world"] == 2
    a, b = ranks[0]["params"], ranks[1]["params"]
    assert a.keys() == b.keys() and len(a) > 10
    moved = 0
    for name in a:
        assert torch.equal(a[name], b[name]), name
        moved += not torch.equal(a[name], ranks[0]["init"][name])
    assert moved > 0  # the step trained
    assert np.isfinite([float(t.abs().sum()) for t in a.values()]).all()
