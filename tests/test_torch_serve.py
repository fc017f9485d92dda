"""``rsprompter_tpu_torch.tools.serve`` on the CPU.

- The unit cases of the JAX package's ``tests/test_serve.py`` (:31, :65,
  :97, :130) on the port's classes, with the same fake inferencers: a
  request whose batch never completes gets 503; a drained batch of mixed
  sizes runs one predict a bucket; each bucket has its own worker thread;
  a smoke predict with malformed output stops the server before it binds.
  Besides: bytes that decode to no image get 400, a predict that raises
  gets 500, and the workers end on ``stop``.
- One in-process server on a tiny-width anchor config: three concurrent
  POSTs (JPEG bytes, PNG bytes, a path) are each answered as the port's
  ``DetInferencer`` predicts the same image, masks as COCO RLE, and
  ``/healthz`` counts them in fewer than 3 batches.
"""

import json
import os
import socket
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest

from rsprompter_tpu_torch.apis.inference import DetInferencer
from rsprompter_tpu_torch.data.io import encode_png
from rsprompter_tpu_torch.evaluation import rle
from rsprompter_tpu_torch.tools import serve as serve_mod
from test_torch_eval import TINY_MODEL

JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg",
                    "scene_444_q90.jpg")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Server:
    """A handler bound to a free port, served from a thread."""

    def __init__(self, worker, **kw):
        self.port = _free_port()
        self.srv = ThreadingHTTPServer(("127.0.0.1", self.port),
                                       serve_mod.make_handler(worker, "m", 0.3, **kw))
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.port}"

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(30)


class _Buckets:
    """JAX's fake inferencer: buckets 256 and 512, empty predictions."""

    def _bucket_for(self, h, w):
        return (256, 256) if max(h, w) <= 256 else (512, 512)

    def __call__(self, imgs, **kw):
        return {"predictions": [{"bboxes": [], "scores": [], "labels": []} for _ in imgs]}


def test_request_timeout_returns_503():
    class StuckWorker:
        batches_run = 0
        images_run = 0

        def submit(self, job):
            pass  # never sets job.event

    with _Server(StuckWorker(), request_timeout=0.2) as url:
        status, payload = _post(url + "/predict", json.dumps({"path": JPEG}).encode())
    assert status == 503 and "timed out" in payload["error"]


def test_bad_bytes_400_and_predict_error_500():
    class Broken(_Buckets):
        def __call__(self, imgs, **kw):
            raise RuntimeError("CUDA error: device-side assert triggered")

    dispatcher = serve_mod.BucketedDispatcher(Broken(), 4, 0.01)
    with _Server(dispatcher) as url:
        assert _post(url + "/predict", b"GIF89a not an image")[0] == 400
        assert _post(url + "/predict", json.dumps({"path": "/no/such.jpg"}).encode())[0] == 400
        status, payload = _post(url + "/predict", encode_png(np.zeros((8, 8, 3), np.uint8)))
    dispatcher.stop()
    assert status == 500 and "device-side assert" in payload["error"]
    assert not any(w.is_alive() for w in dispatcher._workers.values())


def test_batch_worker_groups_by_bucket():
    calls = []

    class Recording(_Buckets):
        def __call__(self, imgs, **kw):
            calls.append(sorted(im.shape[0] for im in imgs))
            return super().__call__(imgs, **kw)

    w = serve_mod.BatchWorker(Recording(), 8, 0.01)
    jobs = [serve_mod._Job(np.zeros((s, s, 3), np.float32), 0.3, False) for s in (200, 400, 220)]
    w._run_batch(jobs)
    assert sorted(calls) == [[200, 220], [400]]
    assert all(j.event.is_set() and j.result is not None for j in jobs)
    assert w.images_run == 3 and w.batches_run == 2


def test_bucketed_dispatcher_concurrent_per_bucket():
    d = serve_mod.BucketedDispatcher(_Buckets(), 8, 0.05)
    jobs = [serve_mod._Job(np.zeros((s, s, 3), np.float32), 0.3, False) for s in (200, 400, 220)]
    for j in jobs:
        d.submit(j)
    for j in jobs:
        assert j.event.wait(timeout=30)
        assert j.result is not None and j.error is None
    assert set(d._workers) == {(256, 256), (512, 512)}
    assert all(w.is_alive() for w in d._workers.values())
    assert d.images_run == 3
    assert d.batches_run == 2  # one a bucket (200 and 220 together)
    d.stop()
    assert not any(w.is_alive() for w in d._workers.values())


def test_smoke_predict_rejects_malformed_output():
    class BrokenInferencer:
        def __call__(self, imgs, **kw):
            return {"predictions": [{"oops": 1}]}

    with pytest.raises(SystemExit):
        serve_mod.smoke_predict(BrokenInferencer(), 64)


def test_refused_flags():
    with pytest.raises(SystemExit):
        serve_mod.parse_args(["cfg.py", "--mask-transfer", "bits"])
    with pytest.raises(SystemExit):
        serve_mod.parse_args(["cfg.py", "--exported", "model.stablehlo"])


def test_served_answers_equal_direct_predicts(tmp_path, capsys):
    cfg = tmp_path / "tiny_serve.py"
    cfg.write_text(f"model = {TINY_MODEL!r}\ncrop_size = (64, 64)\n")
    server = serve_mod.make_server([str(cfg), "--port", "0", "--max-batch", "4",
                                    "--batch-window-ms", "1000", "--device", "cpu"])
    assert "smoke predict 64^2 ok" in capsys.readouterr().out
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    small = np.clip(rng.normal(120, 40, (40, 56, 3)), 0, 255).astype(np.uint8)
    png_path = tmp_path / "small.png"
    png_path.write_bytes(encode_png(small))
    with open(JPEG, "rb") as f:
        jpeg_bytes = f.read()
    bodies = [jpeg_bytes, encode_png(small[::-1].copy()), json.dumps({"path": str(png_path)})
              .encode()]
    images = [cv2.imdecode(np.frombuffer(jpeg_bytes, np.uint8), cv2.IMREAD_COLOR),
              small[::-1].copy(), small]
    try:
        with ThreadPoolExecutor(3) as pool:
            answers = list(pool.map(lambda b: _post(url + "/predict?score_thr=0.0", b), bodies))
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        thin = _post(url + "/predict?score_thr=2&masks=0", bodies[1])
    finally:
        server.shutdown()
        server.server_close()
        server.dispatcher.stop()
        thread.join(30)
    direct = DetInferencer(str(cfg), device="cpu", batch_size=4)
    for (status, payload), img in zip(answers, images):
        assert status == 200
        ref = direct([img], score_thr=0.0)["predictions"][0]
        assert len(ref["scores"]) > 0
        np.testing.assert_array_equal(np.asarray(payload["bboxes"], np.float32), ref["bboxes"])
        np.testing.assert_array_equal(np.asarray(payload["scores"], np.float32), ref["scores"])
        assert payload["labels"] == ref["labels"].tolist()
        masks = np.stack([rle.decode_mask(rle.RLE.from_coco(m)) for m in payload["masks_rle"]])
        np.testing.assert_array_equal(masks, ref["masks"])
    assert health["status"] == "ok" and health["images"] == 3 and health["batches"] < 3
    assert thin == (200, {"bboxes": [], "scores": [], "labels": []})
