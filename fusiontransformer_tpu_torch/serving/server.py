"""Request-batching inference server around :class:`InferenceEngine`.

Port of ``fusiontransformer_tpu/serving/server.py``.  The server overlaps
the host's per-scan work (preprocess with the native quantize, collate with
the native slot maps, de-voxelise) with the device step of the batches
before, and multiplexes many clients onto the engine's captured steps.
``max_batch`` groups requests where the engine's batch size allows it.

Stages, each its own thread(s):
  submit() -> [in queue] -> preprocess workers -> [ready queue] -> dispatch
  thread (groups <= max_batch, ``engine.dispatch_samples``, up to
  ``pipeline_depth`` batches in flight, ``engine.complete``) -> per-request
  Futures.

An HTTP front end (``HTTPFrontend``, the standard library's server) serves
POST /predict (npz body -> npz labels), GET /stats, GET /healthz; the
payloads are the JAX package's, so either package's client talks to either
server.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np


class InferenceServer:
    def __init__(self, engine, preproc_workers: int = 2,
                 max_batch: Optional[int] = None,
                 batch_wait_ms: float = 2.0, max_queue: int = 256,
                 pipeline_depth: int = 2):
        self.engine = engine
        self.max_batch = min(max_batch or engine.batch_size,
                             engine.batch_size)
        self.batch_wait_s = batch_wait_ms / 1000.0
        self.pipeline_depth = max(1, pipeline_depth)
        self._in: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._ready: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._latencies: List[float] = []
        self._lat_lock = threading.Lock()

        self._preproc_threads = [
            threading.Thread(target=self._preproc_loop, daemon=True,
                             name=f"ft-preproc-{i}")
            for i in range(max(1, preproc_workers))]
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="ft-dispatch")
        for t in self._preproc_threads:
            t.start()
        self._dispatch_thread.start()

    # ------------------------------------------------------------------ #
    def submit(self, record: Dict) -> Future:
        """Enqueue a raw scan record; resolves to the engine's result dict."""
        if self._closed:
            raise RuntimeError("server is closed")
        fut: Future = Future()
        self._in.put((record, fut, time.time()))
        return fut

    def predict(self, record: Dict) -> Dict:
        return self.submit(record).result()

    # ------------------------------------------------------------------ #
    def _preproc_loop(self):
        while True:
            item = self._in.get()
            if item is None:
                self._in.put(None)        # propagate to sibling workers
                return
            record, fut, t0 = item
            try:
                sample = self.engine.preprocess(record)
            except Exception as e:       # noqa: BLE001 — report to caller
                fut.set_exception(e)
                continue
            self._ready.put((sample, fut, t0))

    def _collect_group(self, first):
        """Group up to max_batch ready samples, waiting at most
        batch_wait_s after the first."""
        group = [first]
        deadline = time.time() + self.batch_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                nxt = self._ready.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._ready.put(None)
                break
            group.append(nxt)
        return group

    def _complete(self, inflight):
        group, handle = inflight
        try:
            results = self.engine.complete(handle)
        except Exception as e:           # noqa: BLE001 — report to callers
            for _, fut, _ in group:
                fut.set_exception(e)
            return
        now = time.time()
        with self._lat_lock:
            for (_, _, t0) in group:
                self._latencies.append(now - t0)
        for (_, fut, _), res in zip(group, results):
            fut.set_result(res)

    def _dispatch_loop(self):
        """Pipelined dispatch: keep up to ``pipeline_depth`` batches in
        flight (each a copy in, a graph replay and a copy out, enqueued on
        the card's stream) before reading the oldest back, so the card works
        on the next batches while the host de-voxelises the previous one."""
        from collections import deque

        inflight = deque()
        while True:
            try:
                first = self._ready.get(
                    timeout=0.0005 if inflight else None)
            except queue.Empty:
                self._complete(inflight.popleft())   # idle: drain oldest
                continue
            if first is None:
                while inflight:
                    self._complete(inflight.popleft())
                return
            group = self._collect_group(first)
            try:
                handle = self.engine.dispatch_samples(
                    [g[0] for g in group])
            except Exception as e:       # noqa: BLE001 — report to callers
                for _, fut, _ in group:
                    fut.set_exception(e)
                continue
            inflight.append((group, handle))
            while len(inflight) > self.pipeline_depth:
                self._complete(inflight.popleft())

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict:
        with self._lat_lock:
            lats = np.asarray(self._latencies, np.float64)
        out = dict(self.engine.stats())
        out["requests_completed"] = int(lats.size)
        if lats.size:
            out["latency_ms"] = {
                "p50": round(float(np.percentile(lats, 50)) * 1000, 3),
                "p95": round(float(np.percentile(lats, 95)) * 1000, 3),
                "p99": round(float(np.percentile(lats, 99)) * 1000, 3),
                "mean": round(float(lats.mean()) * 1000, 3),
            }
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._in.put(None)
        # Join preproc workers FIRST: a worker mid-preprocess still publishes
        # its sample to _ready before exiting, so the dispatch sentinel must
        # only be enqueued after every worker is done — otherwise that last
        # sample lands behind the sentinel and its Future never resolves.
        for t in self._preproc_threads:
            t.join(timeout=10)
        self._ready.put(None)
        self._dispatch_thread.join(timeout=10)


# ---------------------------------------------------------------------- #
# HTTP front end (standard library only; payloads are .npz).
# ---------------------------------------------------------------------- #
def encode_record(record: Dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **record)
    return buf.getvalue()


def decode_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class HTTPFrontend:
    """POST /predict (npz: points, feats, img, points_img) → npz labels;
    GET /stats → JSON; GET /healthz → 'ok'."""

    def __init__(self, server: InferenceServer, host="127.0.0.1", port=0):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, b"ok", "text/plain")
                elif self.path == "/stats":
                    self._reply(200, json.dumps(
                        outer.server.stats()).encode(), "application/json")
                else:
                    self._reply(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    record = decode_npz(self.rfile.read(n))
                    res = outer.server.predict(record)
                    body = encode_record(
                        {k: np.asarray(v) for k, v in res.items()})
                    self._reply(200, body, "application/octet-stream")
                except Exception as e:   # noqa: BLE001
                    self._reply(400, str(e).encode(), "text/plain")

        self.server = server
        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="ft-http")

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
