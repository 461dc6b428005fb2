"""Startup probe of the streaming configurations.

Port of `d3roma_tpu/streaming/probe.py`. At serving startup each candidate
`task.fast_inference` mode is tried in a child process that the parent can
kill (a hung kernel build or a faulting launch takes the child, not the
server), in the JAX package's order of preference, and the first that
builds its kernels and serves one frame wins. On the card a candidate that
fails is a failure to look into, not only a fall-through: its exit status
and the end of its stderr are in the outcome, which is returned, shown in
the server's /metrics and appended to `.bench_cache/results.jsonl`.

    python -m d3roma_tpu_torch.streaming.probe [--height H] [--width W]
        [--batch N] [--device D] [overrides...]

is the child: it builds `D3RoMa` (rgb+raw) at the candidate's overrides and
pushes `--batch` frames through `infer_with_rgb_raw_batch`; exit 0 when the
depth is finite.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the candidates, in the JAX package's order of preference
STREAMING_CANDIDATES = ("latency", "dense", "throughput")

_CANDIDATE_OVERRIDES = {
    "latency": ["task.fast_inference=latency"],
    "dense": ["task.fast_inference=dense"],
    "throughput": ["task.fast_inference=throughput"],
}


def probe_child_main(argv: Optional[List[str]] = None) -> int:
    """The child: build the serving pipeline at the candidate's overrides
    and serve `--batch` frames. Exit 0 = the configuration runs."""
    import argparse

    import numpy as np

    ap = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.streaming.probe")
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.utils.camera import Realsense

    droma = D3RoMa(args.overrides, Realsense.default_real("fxm"), variant="rgb+raw",
                   device=args.device)
    rgb = np.zeros((args.height, args.width, 3), np.uint8)
    raw = np.ones((args.height, args.width), np.float32)
    out = droma.infer_with_rgb_raw_batch([(rgb, raw)] * args.batch)
    assert len(out) == args.batch and np.all(np.isfinite(out[0]))
    print("probe ok", flush=True)
    return 0


def select_streaming_mode(
    overrides: Sequence[str],
    candidates: Sequence[str] = STREAMING_CANDIDATES,
    timeout_s: float = 2400.0,
    batch: int = 1,
    height: int = 360,
    width: int = 640,
    records_path: Optional[str] = None,
    device: Optional[str] = None,
) -> dict:
    """Try `candidates` in order; return ``{"mode": <winner or None>,
    "overrides": [...], "probe": [...]}``.

    Each candidate runs in a child process, killed at `timeout_s`. The
    candidate's overrides follow the caller's `overrides`, so the child runs
    exactly what serving would; the winner's whole override list is
    returned for the caller to build its pipeline with. A failed candidate's
    record carries its exit status and the end of its stderr."""
    results = []
    winner = None
    win_overrides = list(overrides)
    # the child imports this checkout's package, wherever its working directory
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    for cand in candidates:
        extra = _CANDIDATE_OVERRIDES[cand]
        cmd = [sys.executable, "-m", "d3roma_tpu_torch.streaming.probe",
               "--height", str(height), "--width", str(width), "--batch", str(batch)]
        if device is not None:
            cmd += ["--device", str(device)]
        cmd += list(overrides) + extra
        t0 = time.time()
        try:
            r = subprocess.run(cmd, timeout=timeout_s, capture_output=True, env=env)
            ok = r.returncode == 0
            err = "" if ok else (f"exit {r.returncode}: "
                                 + (r.stderr or b"").decode(errors="replace")[-300:])
        except subprocess.TimeoutExpired:
            ok, err = False, f"probe timed out after {timeout_s:.0f}s"
        dt = time.time() - t0
        results.append({"mode": cand, "ok": ok, "seconds": round(dt, 1),
                        **({"error": err} if err else {})})
        if ok:
            logger.info("streaming probe %s: ok in %.1fs", cand, dt)
            winner = cand
            win_overrides = list(overrides) + extra
            break
        logger.warning("streaming probe %s FAILED in %.1fs: %s", cand, dt, err)
    out = {"mode": winner, "overrides": win_overrides, "probe": results}
    _record(out, records_path)
    return out


def _record(outcome: dict, records_path: Optional[str]) -> None:
    path = records_path or os.path.join(_ROOT, ".bench_cache", "results.jsonl")
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({"kind": "streaming_probe", "ts": int(time.time()),
                                **outcome}) + "\n")
    except OSError as e:  # the records are telemetry, not a result
        logger.warning("streaming probe record write failed: %s", e)


if __name__ == "__main__":
    sys.exit(probe_child_main())
