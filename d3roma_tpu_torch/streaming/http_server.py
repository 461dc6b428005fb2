"""HTTP serving front end for depth restoration.

Port of `d3roma_tpu/streaming/http_server.py`. The reference's only network
deployment is its ROS node (d3roma_processor.py:24-286); this is the non-ROS
one: a threaded stdlib HTTP server whose concurrent requests aggregate
through `MicroBatcher` into batched pipeline calls.

Endpoints:
  POST /v1/infer_rgb_raw   body: .npz with `rgb` (uint8 [H,W,3] or [H,W])
                           and `raw_depth` (float [H,W], meters). Response:
                           .npz with `depth` (float32 [H,W], meters).
                           Malformed arrays get a 400 before entering the
                           micro-batch (one bad frame must not fail its
                           co-batched neighbours); a full backlog a 503; a
                           model error a 500; a stalled device a 504 after
                           `request_timeout_s`.
  GET  /healthz            {"status": "ok"} once ready: after the warm-up
                           inference when `warmup_input` is given (the
                           first call builds the kernels), 503 {"status":
                           "warming"} until then. A warm-up that failed, or
                           returned a non-finite depth, is reported as
                           "warmup_error" in the body.
  GET  /metrics            JSON counters: requests, errors, frames, the
                           batcher's, latency p50/p90/p99 ms.

No third-party dependency; payloads are numpy `.npz`, which round-trips
float depth exactly. `python -m d3roma_tpu_torch.serve` wires this to a
`D3RoMa`.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np

from d3roma_tpu_torch.streaming.batcher import MicroBatcher

__all__ = ["InferenceHTTPServer"]

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 * 1024 * 1024  # refuse absurd uploads before reading them


class _Metrics:
    """Coarse serving counters; one lock, a bounded latency window."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.frames = 0
        self._lat_ms = deque(maxlen=window)

    def observe(self, ok: bool, latency_s: float):
        with self._lock:
            self.requests += 1
            if ok:
                self.frames += 1
                self._lat_ms.append(latency_s * 1000.0)
            else:
                self.errors += 1

    def snapshot(self, batcher: MicroBatcher) -> dict:
        with self._lock:
            lats = sorted(self._lat_ms)
            out = {
                "requests": self.requests,
                "errors": self.errors,
                "frames_served": self.frames,
                "batches": batcher.batches,
                "batched_items": batcher.items,
                "padded_rows": batcher.padded_rows,
            }
            if lats:
                def q(p):
                    return lats[min(len(lats) - 1, int(p * (len(lats) - 1)))]

                out["latency_ms"] = {"p50": round(q(0.50), 1), "p90": round(q(0.90), 1),
                                     "p99": round(q(0.99), 1)}
            return out


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _validate_frame(z) -> tuple:
    """Decode and check one request's arrays. Raises ValueError with a
    message the client can act on. Checked per request, before the frame
    enters the shared micro-batch, so one malformed frame cannot fail the
    whole batch."""
    for k in ("rgb", "raw_depth"):
        if k not in z:
            raise ValueError(f"missing array {k!r}")
    rgb, raw = z["rgb"], z["raw_depth"]
    # uint8 is required, not coerced: a cast would truncate [0,1] floats to
    # zeros and serve a plausible depth map for a black image
    if rgb.dtype != np.uint8:
        raise ValueError(
            f"rgb must be uint8 (got {rgb.dtype}); scale [0,1] floats by 255 and cast on "
            "the client")
    if not (rgb.ndim == 2 or (rgb.ndim == 3 and rgb.shape[-1] == 3)):
        raise ValueError(f"rgb must be [H,W,3] or [H,W] (got shape {rgb.shape})")
    if rgb.shape[0] < 1 or rgb.shape[1] < 1:
        raise ValueError(f"rgb must be non-empty (got shape {rgb.shape})")
    if not np.issubdtype(raw.dtype, np.floating):
        raise ValueError(f"raw_depth must be float meters (got {raw.dtype})")
    if raw.ndim != 2:
        raise ValueError(f"raw_depth must be [H,W] (got shape {raw.shape})")
    if raw.shape != rgb.shape[:2]:
        raise ValueError(f"raw_depth {raw.shape} does not match rgb {rgb.shape[:2]}")
    return rgb, np.asarray(raw, np.float32)


class InferenceHTTPServer:
    """`infer_batch` takes a list of (rgb, raw_depth) tuples and returns the
    frames' depth arrays in order: the contract of
    `D3RoMa.infer_with_rgb_raw_batch`; any callable of that form serves."""

    def __init__(
        self,
        infer_batch: Callable[[List], Sequence],
        max_batch: int = 16,
        max_wait_ms: float = 25.0,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: Optional[float] = 300.0,
        warmup_input: Optional[tuple] = None,
        probe_info: Optional[dict] = None,
    ):
        """`request_timeout_s` bounds how long a request waits on the model
        (expiry answers 504). `warmup_input` is one (rgb, raw_depth) frame
        pushed through the batcher at start(); /healthz answers 503
        "warming" until it completes. `probe_info` (streaming/probe.py's
        outcome) is shown in `metrics`."""
        self._batcher = MicroBatcher(infer_batch, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._metrics = _Metrics()
        self._host = host
        self._port = port
        self._timeout_s = request_timeout_s
        self._warmup_input = warmup_input
        self._probe_info = probe_info
        self._ready = threading.Event()
        self._warmup_error: Optional[str] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 - stdlib logs each request
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj: dict):
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    if not server._ready.is_set():
                        self._reply_json(503, {"status": "warming"})
                        return
                    body = {"status": "ok", "frames_served": server._metrics.frames}
                    if server._warmup_error:
                        body["warmup_error"] = server._warmup_error
                    self._reply_json(200, body)
                elif self.path == "/metrics":
                    self._reply_json(200, server._metrics.snapshot(server._batcher))
                else:
                    self._reply_json(404, {"error": "unknown path"})

            def do_POST(self):  # noqa: N802
                if self.path != "/v1/infer_rgb_raw":
                    self._reply_json(404, {"error": "unknown path"})
                    return
                t0 = time.monotonic()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not 0 < n <= MAX_BODY_BYTES:
                        raise ValueError(f"bad Content-Length {n}")
                    with np.load(io.BytesIO(self.rfile.read(n))) as z:
                        rgb, raw = _validate_frame(z)
                except Exception as e:  # noqa: BLE001 - a client error
                    server._metrics.observe(False, 0.0)
                    self._reply_json(400, {"error": f"{type(e).__name__}: {e}"[:300]})
                    return
                try:
                    try:
                        fut = server._batcher.submit((rgb, raw))
                    except queue.Full:
                        # backpressure: a blocking put would pile up handler
                        # threads that the request timeout cannot bound
                        server._metrics.observe(False, 0.0)
                        self._reply_json(503, {"error": "server overloaded (queue full)"})
                        return
                    depth = fut.result(timeout=server._timeout_s)
                    body = _npz_bytes(depth=np.asarray(depth, np.float32))
                    server._metrics.observe(True, time.monotonic() - t0)
                    self._reply(200, body, "application/x-npz")
                except FutureTimeout:
                    server._metrics.observe(False, 0.0)
                    logger.error("inference timed out after %.0fs", server._timeout_s or 0)
                    self._reply_json(504, {"error": f"inference timed out ({server._timeout_s}s)"})
                except Exception as e:  # noqa: BLE001 - a model or server error
                    server._metrics.observe(False, 0.0)
                    logger.exception("inference failed")
                    self._reply_json(500, {"error": f"{type(e).__name__}: {e}"[:300]})

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="d3roma-http",
                                        daemon=True)
        self._thread.start()
        if self._warmup_input is None:
            self._ready.set()
        else:
            threading.Thread(target=self._warm, name="d3roma-http-warmup", daemon=True).start()
        port = self._httpd.server_address[1]
        logger.info("serving on http://%s:%d", self._host, port)
        return port

    def _warm(self):
        try:
            depth = np.asarray(self._batcher.submit(self._warmup_input).result())
            if not np.isfinite(depth).all():
                raise FloatingPointError(
                    f"warm-up depth has {int((~np.isfinite(depth)).sum())} non-finite values")
            logger.info("warm-up inference done; serving ready")
        except Exception as e:  # noqa: BLE001
            # serving may still work (a transient device error): report the
            # failure on /healthz rather than never becoming ready
            self._warmup_error = f"{type(e).__name__}: {e}"[:300]
            logger.exception("warm-up inference failed")
        self._ready.set()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._batcher.stop()

    @property
    def metrics(self) -> dict:
        m = self._metrics.snapshot(self._batcher)
        if self._probe_info is not None:
            m["streaming_probe"] = self._probe_info
        return m
