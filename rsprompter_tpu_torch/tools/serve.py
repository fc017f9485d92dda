"""Batched HTTP model server on the card.

    python -m rsprompter_tpu_torch.tools.serve CONFIG [CKPT] [--host 127.0.0.1] \\
        [--port 8000] [--max-batch 8] [--batch-window-ms 10] \\
        [--size-buckets 512,1024] [--warmup] [--score-thr 0.3] \\
        [--request-timeout S] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/serve.py``. Requests
queue up; one worker thread a size bucket (``BucketedDispatcher``) drains up
to ``--max-batch`` of them every ``--batch-window-ms`` and serves them with
one batched predict (``BatchWorker``): small images never pay the large
bucket's compute or wait out its window. The workers share one
``DetInferencer``, whose lock keeps their predicts from interleaving on the
card. ``--warmup`` runs one predict a bucket at ``--max-batch`` (cuBLAS and
cuDNN handles, the kernels' first launches) before the port binds, and a
smoke predict on the smallest bucket always runs first, so that a server
with unusable weights fails at start-up (``smoke_predict``).

API:
  GET  /healthz   -> {"status": "ok", "model": ..., "batches": N, "images": N}
  POST /predict   -> body: raw image bytes (JPEG, PNG or .npy, decoded by the
                     port's ``data.io.decode_image``) or JSON {"path": "..."};
                     response: {"bboxes": [[x1, y1, x2, y2], ...],
                     "scores": [...], "labels": [...], "masks_rle": [COCO RLE
                     (uncompressed counts), ...]};
                     query: ?score_thr=0.3&masks=0
  400 on bytes that do not decode, 503 when a request waited longer than
  ``--request-timeout`` (0: forever), 500 when its predict failed.

Not taken: JAX's ``--mask-transfer`` other than ``u8`` (``f32``, ``bits``,
``flat``: transfers for TPU links, ROADMAP "Do not port"; argparse accepts
only ``u8``) and ``--exported`` (a StableHLO artifact of the JAX model; no
such export exists for the port, so argparse does not know the flag). Runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from rsprompter_tpu_torch.data.io import decode_image, imread
from rsprompter_tpu_torch.evaluation.rle import encode_masks


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="batched inference server")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0: a free port")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=10.0)
    p.add_argument("--size-buckets", default=None,
                   help="comma list, e.g. 512,1024 (default: config crop)")
    p.add_argument("--warmup", action="store_true",
                   help="one predict a size bucket at --max-batch before accepting requests")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--mask-transfer", default="u8", choices=("u8",),
                   help="device->host mask encoding: uint8 probabilities (the only one "
                        "the port ships)")
    p.add_argument("--request-timeout", type=float, default=0.0,
                   help="seconds a request may wait for its batch result before the "
                        "server answers 503 (default 0 = wait forever)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


class _Job:
    __slots__ = ("img", "score_thr", "masks", "event", "result", "error")

    def __init__(self, img, score_thr, masks):
        self.img = img
        self.score_thr = score_thr
        self.masks = masks
        self.event = threading.Event()
        self.result = None
        self.error = None


class BatchWorker(threading.Thread):
    """One thread draining its queue into batched predicts."""

    def __init__(self, inferencer, max_batch: int, window_s: float):
        super().__init__(daemon=True)
        self.inferencer = inferencer
        self.max_batch = max_batch
        self.window_s = window_s
        self.jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self.batches_run = 0
        self.images_run = 0

    def submit(self, job: _Job) -> None:
        self.jobs.put(job)

    def stop(self) -> None:
        """End the thread once the jobs queued before are served."""
        self.jobs.put(None)

    def run(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            batch = [job]
            deadline = time.monotonic() + self.window_s
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    job = self.jobs.get(timeout=remaining)
                except queue.Empty:
                    break
                if job is None:
                    stop = True
                    break
                batch.append(job)
            self._run_batch(batch)
            if stop:
                return

    def _run_batch(self, batch) -> None:
        # one predict a size bucket: small images never pay big-bucket
        # compute, and every sub-batch is made at one input size
        groups: "dict[tuple, list[_Job]]" = {}
        for j in batch:
            h, w = j.img.shape[:2]
            groups.setdefault(self.inferencer._bucket_for(h, w), []).append(j)
        for jobs in groups.values():
            try:
                out = self.inferencer([j.img for j in jobs], return_masks=True,
                                      score_thr=0.0)["predictions"]
                self.batches_run += 1
                self.images_run += len(jobs)
                for j, pred in zip(jobs, out):
                    j.result = self._post(pred, j)
            except Exception as e:  # the worker keeps serving; the clients get 500
                traceback.print_exc()
                for j in jobs:
                    j.error = f"{type(e).__name__}: {e}"
            finally:
                for j in jobs:
                    j.event.set()

    @staticmethod
    def _post(pred, job: _Job) -> dict:
        scores = np.asarray(pred["scores"], np.float32)
        keep = scores > job.score_thr
        out = {
            "bboxes": np.asarray(pred["bboxes"], np.float32).reshape(-1, 4)[keep].tolist(),
            "scores": scores[keep].tolist(),
            "labels": np.asarray(pred["labels"], np.int64)[keep].tolist(),
        }
        if job.masks and "masks" in pred:
            masks = np.asarray(pred["masks"])[keep]
            out["masks_rle"] = [r.to_coco() for r in encode_masks(masks)]
        return out


class BucketedDispatcher:
    """One ``BatchWorker`` (queue and batching window) a size bucket,
    started at the bucket's first job."""

    def __init__(self, inferencer, max_batch: int, window_s: float):
        self.inferencer = inferencer
        self.max_batch = max_batch
        self.window_s = window_s
        self._workers: "dict[tuple, BatchWorker]" = {}
        self._lock = threading.Lock()

    def submit(self, job: _Job) -> None:
        h, w = job.img.shape[:2]
        bucket = self.inferencer._bucket_for(h, w)
        with self._lock:
            worker = self._workers.get(bucket)
            if worker is None:
                worker = BatchWorker(self.inferencer, self.max_batch, self.window_s)
                worker.start()
                self._workers[bucket] = worker
        worker.submit(job)

    def stop(self, timeout: float = 60.0) -> None:
        """End every worker once its queued jobs are served."""
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout)

    @property
    def batches_run(self) -> int:
        return sum(w.batches_run for w in self._workers.values())

    @property
    def images_run(self) -> int:
        return sum(w.images_run for w in self._workers.values())


def smoke_predict(inferencer, size: int) -> None:
    """One real predict through the whole pipeline before the port binds,
    so that a server with garbage weights or a broken build fails at
    start-up instead of answering its first client 500."""
    t0 = time.perf_counter()
    out = inferencer([np.zeros((size, size, 3), np.uint8)], return_masks=True,
                     score_thr=1.0)["predictions"]
    if not out or not {"bboxes", "scores", "labels"} <= set(out[0]):
        raise SystemExit(f"smoke predict returned malformed predictions: {out!r:.200}")
    print(f"smoke predict {size}^2 ok ({time.perf_counter() - t0:.1f}s)", flush=True)


def make_handler(worker, model_name: str, default_thr: float, request_timeout: float = 0.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._send(200, {"status": "ok", "model": model_name,
                                 "batches": worker.batches_run, "images": worker.images_run})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if urlparse(self.path).path != "/predict":
                self._send(404, {"error": "not found"})
                return
            q = parse_qs(urlparse(self.path).query)
            try:
                thr = float(q.get("score_thr", [default_thr])[0])
            except ValueError:
                self._send(400, {"error": "score_thr is not a number"})
                return
            want_masks = q.get("masks", ["1"])[0] not in ("0", "false")
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                img = self._decode(data)
            except (ValueError, KeyError, OSError) as e:
                self._send(400, {"error": f"bad image: {e}"})
                return
            job = _Job(img, thr, want_masks)
            worker.submit(job)
            if not job.event.wait(request_timeout or None):
                self._send(503, {"error": f"timed out after {request_timeout:.0f}s "
                                          "(device busy; retry later)"})
                return
            if job.error:
                self._send(500, {"error": job.error})
            else:
                self._send(200, job.result)

        @staticmethod
        def _decode(data: bytes) -> np.ndarray:
            if data[:1] == b"{":
                return imread(json.loads(data)["path"])
            return decode_image(data)

    return Handler


def make_server(argv: Optional[Sequence[str]] = None) -> ThreadingHTTPServer:
    """Everything ``main`` does before it serves: the inferencer (weights
    checked on the host first), the dispatcher, the warm-up and the smoke
    predict, then the bound server. The server's ``dispatcher`` and
    ``inferencer`` attributes are the ones it serves with; call
    ``serve_forever`` on it, then ``shutdown``, ``server_close`` and
    ``dispatcher.stop``."""
    from rsprompter_tpu_torch.apis.inference import DetInferencer

    args = parse_args(argv)
    buckets = [int(s) for s in args.size_buckets.split(",")] if args.size_buckets else None
    if args.checkpoint and not os.path.exists(args.checkpoint):
        sys.exit(f"checkpoint not found: {args.checkpoint}")
    inferencer = DetInferencer(args.config, weights=args.checkpoint, device=args.device,
                               batch_size=args.max_batch, size_buckets=buckets)
    inferencer.verify_weights()
    dispatcher = BucketedDispatcher(inferencer, args.max_batch, args.batch_window_ms / 1e3)
    if args.warmup:
        for size in buckets or [inferencer.crop_size[0]]:
            t0 = time.perf_counter()
            inferencer([np.zeros((size, size, 3), np.uint8)] * args.max_batch,
                       return_masks=True, score_thr=1.0)
            print(f"warmup {size}^2 x{args.max_batch}: {time.perf_counter() - t0:.1f}s",
                  flush=True)
    smoke_predict(inferencer, min(buckets) if buckets else inferencer.crop_size[0])
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(dispatcher, os.path.basename(args.config), args.score_thr,
                     args.request_timeout))
    server.dispatcher, server.inferencer = dispatcher, inferencer
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (max_batch={args.max_batch}, "
          f"window={args.batch_window_ms}ms, device={inferencer.device})", flush=True)
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = make_server(argv)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        server.dispatcher.stop()


if __name__ == "__main__":
    main()
