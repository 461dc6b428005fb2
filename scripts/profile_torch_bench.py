#!/usr/bin/env python3
"""Where one call of the port's bench goes on the card: device busy, idle
share, peak memory and device time by kernel, for the BENCH_* setting in the
environment.

    BENCH_QUANT=static python3 scripts/profile_torch_bench.py [--calls 2]
    BENCH_MODEL=pixel python3 scripts/profile_torch_bench.py

Builds the bench's pipeline (`d3roma_tpu_torch/bench.py::bench_ldm`, or
`bench_pixel` with BENCH_MODEL=pixel; the same knobs and defaults, batch
16), makes one warm call, then profiles
`--calls` calls enqueued back to back as the bench times them (one
synchronize at the end) under torch.profiler: the wall time, the summed
device time of the kernels, memsets and copies, the idle share
(1 - busy / wall), the device ms a call by kernel group (chip_smoke.py's
groups: the port's kernels by name, then the library's) and the twelve
largest kernels. Prints the card's name and power limit first and one JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d3roma_tpu_torch import bench

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    model = os.environ.get("BENCH_MODEL", "ldm")
    run, tag, _, device = (bench.bench_pixel if model == "pixel" else bench.bench_ldm)(
        batch, args.calls)
    run(0)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [run(i) for i in range(1, args.calls + 1)]
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    del outs
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((us / 1e3, evt.count, evt.key))
    busy = sum(ms for ms, _, _ in kernels)
    frames = batch * args.calls
    from chip_smoke import _group

    groups = {}
    for ms, _, name in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms / args.calls
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"  top: {ms / args.calls:8.2f} ms a call  x{count // args.calls:<5d} {name[:100]}",
              flush=True)
    print(json.dumps({
        "config": tag, "quant": os.environ.get("BENCH_QUANT", bench.DEFAULT_QUANT),
        "batch": batch, "calls": args.calls, "card": card,
        "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "wall_ms_per_frame": wall_ms / frames, "device_busy_ms_per_frame": busy / frames,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_ops_per_call": sum(c for _, c, _ in kernels) / args.calls,
        "device_ms_per_call_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
