#!/usr/bin/env python3
"""Run the port's bench (`python -m d3roma_tpu_torch.bench`) over BENCH_QUANT
settings on one CUDA card, in turns, and keep every JSON line.

    python3 scripts/torch_bench_sweep.py --runs 3 --quants static,0,all,dense,wino,vae8 \
        --singles 1,mxu,halo,wino_static --out bench_sweep.jsonl

Each of --runs rounds runs every setting of --quants once (so the settings
alternate and a drift of the card or the host touches all of them); then
every setting of --singles runs once, with --single-reps timed calls. Every
run is its own process with the bench's defaults (batch 16, 12 timed calls,
DeepCache 2d2, the fused GEGLU, the whole-row attention) but for the knob
set, and one scale cache shared by the sweep (a static setting calibrates
in its first run and replays the cached scales after, the bench's deployed
behaviour). Prints the card's name and power limit before and after, each
run's line and wall seconds; writes one JSON object a run to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _run(quant: str, cache_dir: str, extra: dict, timeout: int) -> dict:
    env = dict(os.environ, BENCH_QUANT=quant, BENCH_CACHE_DIR=cache_dir, **extra)
    env.pop("BENCH_RECORDS", None)  # the records follow BENCH_CACHE_DIR
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "d3roma_tpu_torch.bench"], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    line = json.loads(out[-1]) if out else {"error": "no output"}
    return {"quant": quant, "env": extra, "exit": proc.returncode, "wall_s": wall,
            "line": line, "stderr_tail": proc.stderr.strip().splitlines()[-4:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--quants", default="static,0,all,dense,wino,vae8")
    ap.add_argument("--singles", default="")
    ap.add_argument("--single-reps", default="3")
    ap.add_argument("--batch", default="16")
    ap.add_argument("--timeout", type=int, default=900, help="seconds a run may take")
    ap.add_argument("--out", default=os.path.join(_REPO, ".bench_cache", "bench_sweep.jsonl"))
    args = ap.parse_args()
    print(_card(), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = 0
    with tempfile.TemporaryDirectory() as cache, open(args.out, "a") as f:
        plan = [(r, q, {"BENCH_BATCH": args.batch}) for r in range(args.runs)
                for q in args.quants.split(",") if q]
        plan += [(0, q, {"BENCH_BATCH": args.batch, "BENCH_REPS": args.single_reps})
                 for q in args.singles.split(",") if q]
        for r, quant, extra in plan:
            rec = dict(_run(quant, cache, extra, args.timeout), round=r, card=_card())
            failed += rec["exit"] != 0
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(f"round {r} BENCH_QUANT={quant} {extra}: exit {rec['exit']} in "
                  f"{rec['wall_s']:.1f}s: {json.dumps(rec['line'])}", flush=True)
            for ln in rec["stderr_tail"]:
                print(f"  stderr: {ln}", flush=True)
    print(_card(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
