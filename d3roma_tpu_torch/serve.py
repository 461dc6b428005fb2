"""Serve the rgb+raw depth-restoration model over HTTP (the counterpart of
the repository's scripts/serve_http.py).

    python -m d3roma_tpu_torch.serve [--host H] [--port P] [--max-batch N]
        [--max-wait-ms MS] [--auto-mode] [--probe-timeout S] [--device D] -- \\
        task=eval_ldm_mixed_rgb+raw task.resume_pretrained=DIR \\
        task.num_intermediate_images=1 task.fast_inference=throughput

Concurrent requests micro-batch into one `D3RoMa.infer_with_rgb_raw_batch`
call of `--max-batch` frames (streaming/http_server.py); the batched path
needs `task.num_intermediate_images=1`. One warm frame (black, a constant
1 m depth) goes through the model before /healthz reports ready; a warm-up
that fails or returns a non-finite depth shows as "warmup_error" there.
Prints `serving on http://HOST:PORT ...` with the bound port (`--port 0`
binds a free one). `--auto-mode` first runs streaming/probe.py's candidates
(latency, dense, throughput) in child processes and serves the first that
runs; when none runs it prints each one's error and exits 1. SIGTERM or
SIGINT stops the server and exits 0. Runs on CUDA unless `--device` names
another device.

Client:
  import io, urllib.request, numpy as np
  buf = io.BytesIO(); np.savez_compressed(buf, rgb=rgb, raw_depth=raw)
  r = urllib.request.urlopen(urllib.request.Request(
      "http://host:8080/v1/infer_rgb_raw", buf.getvalue(), method="POST"))
  depth = np.load(io.BytesIO(r.read()))["depth"]
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.serve")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--auto-mode", action="store_true",
                    help="try the streaming modes (latency > dense > throughput) in child "
                         "processes and serve the first that runs (exit 1 when none does); "
                         "the outcome is in /metrics")
    ap.add_argument("--probe-timeout", type=float, default=2400.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*", help="config overrides (task=..., task.*=...)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np

    from d3roma_tpu_torch.device import resolve_device
    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.streaming import InferenceHTTPServer
    from d3roma_tpu_torch.utils.camera import Realsense

    resolve_device(args.device)  # no CUDA and no --device: fail before probing
    overrides = list(args.overrides)
    probe_info = None
    if args.auto_mode:
        from d3roma_tpu_torch.streaming.probe import select_streaming_mode

        probe_info = select_streaming_mode(overrides, batch=args.max_batch,
                                           timeout_s=args.probe_timeout, device=args.device)
        if probe_info["mode"] is None:
            # a kernel that fails to build or to run is a fault to report,
            # never a reason to serve the plain versions instead
            print("# streaming probe: no candidate ran; not serving", file=sys.stderr, flush=True)
            for rec in probe_info["probe"]:
                print(f"#   {rec['mode']}: {rec.get('error', 'ok')}", file=sys.stderr,
                      flush=True)
            return 1
        print(f"# streaming probe selected mode={probe_info['mode']}", flush=True)
        overrides = probe_info["overrides"]

    droma = D3RoMa(overrides, Realsense.default_real("fxm"), variant="rgb+raw",
                   device=args.device)
    # one frame drives the first call (the kernels' builds) before /healthz
    # reports ready; any HxW works, the model resizes on ingest
    warm = (np.zeros((360, 640, 3), np.uint8), np.ones((360, 640), np.float32))
    server = InferenceHTTPServer(
        droma.infer_with_rgb_raw_batch, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, host=args.host, port=args.port,
        warmup_input=warm, probe_info=probe_info)
    port = server.start()
    print(f"serving on http://{args.host}:{port} (POST /v1/infer_rgb_raw, GET /healthz /metrics)",
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.wait(3600):
        pass
    server.stop()
    print("server stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
