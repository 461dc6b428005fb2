#!/usr/bin/env python3
"""Time the dynamic int8 conv and dense (`conv2d_int8_dynamic`, the int8
ops of quant=True / "all" / "dense") of a tree of this repository on a CUDA
card.

    python3 scripts/time_dynamic.py [--tree DIR] [--label NAME]

Imports d3roma_tpu_torch from DIR (default: this repository; its kernels
build from DIR's csrc/ at first use) and times, with chip_smoke.py's helpers
(CUDA events in turns with the library call, K L L K; torch.profiler for the
device ms of one call by launch and its device ops; the device span of one
call, first kernel's start to last one's end, behind a sleep kernel; host ms
to issue one call right after a synchronize, the median of seven means):

- PERF.md's dynamic rows at batch 2: the cross-attention's 4-row key/value
  dense (1024 -> 320), the transformers' dense layers (7200 x 320, 1840 x
  640, 480 x 1280), the UNet's 45x80 320 -> 320 3x3 and stride-2 convs and
  its 640 -> 320 1x1 shortcut, the VAE's B4 361x641 128 -> 128 stride 2 and
  B2 360x640 256 -> 128 1x1 and its B4 360x640 128 -> 128 3x3;
- the batch-16 dense layers of "all" (chip_smoke.py's
  DYNAMIC_DENSE_SHAPES_B16: each UNet level's attention projection, the
  unfused feed-forward's two denses, the key/value projections) and the
  batch-16 stride-2 and 1x1 convs (UNet 45x80 320, VAE B32 361x641 128,
  VAE B16 360x640 256 -> 128);

each against one PyTorch call of the same function in bf16 (F.linear,
F.conv2d channels_last); then, where the tree has route_plan, the dense
layers the plan sends to the one-launch "small" route (4 and 32 rows, K
1024) on that route and on the "rows" route, the same launch helper in
turns (small, rows, rows, small), both checked bit-equal to the plain
version. Inputs are random, seeded on the card, each batch
item (row) at its own absmax. Prints the card's name and power limit, then
one JSON line. To compare two trees on one card, run it on both in one
session, in turns (parent, change, change, parent). Needs one card and
nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CONVS_B2 = ((2, 45, 80, 320, 320, 3, 2, 1), (2, 45, 80, 320, 320, 3, 1, 1),
            (2, 45, 80, 640, 320, 1, 1, 0),
            (4, 361, 641, 128, 128, 3, 2, 0), (2, 360, 640, 256, 128, 1, 1, 0),
            (4, 360, 640, 128, 128, 3, 1, 1))
DENSE_B2 = ((4, 1024, 320), (7200, 320, 320), (1840, 640, 640), (480, 1280, 1280))
CONVS_B16 = ((16, 45, 80, 320, 320, 3, 2, 1), (32, 361, 641, 128, 128, 3, 2, 0),
             (16, 360, 640, 256, 128, 1, 1, 0))
SMALL_DENSE = ((4, 1024, 320), (32, 1024, 320), (32, 1024, 640), (32, 1024, 1280))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("time_dynamic: no CUDA device is available")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from d3roma_tpu_torch.ops import kernels as K
    from d3roma_tpu_torch.ops.quant import int8_linear_dynamic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"package {Path(K.__file__).resolve().parents[2]}", flush=True)
    K._build.build(["conv2d_int8"])
    gen = torch.Generator(device="cuda").manual_seed(1357)
    rows = []

    def host_ms(fn, repeats=7, calls=20):
        """The median over `repeats` of the mean host ms to issue one of
        `calls` calls right after a synchronize."""
        fn()
        means = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            means.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
        return statistics.median(means)

    def device_span_ms(fn, reps=20):
        """The device's span of one call behind a ~1 ms sleep kernel (the
        host enqueues the whole call first); median of `reps` calls."""
        fn()
        spans = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
        return statistics.median(spans)

    def record(kind, shape, fn, library, bound_ms):
        row = {"kernel": kind, "shape": list(shape)}
        row["ms"], row["library_ms"] = cs.time_in_turns(fn, library)
        _, row["device_ms"], row["device_ms_by_launch"] = cs.host_and_device_ms(fn)
        row["host_ms"] = host_ms(fn)
        row["device_span_ms"] = device_span_ms(fn)
        row["device_ops_per_call"] = cs.device_ops_per_call(fn)
        row["bound_ms"] = bound_ms
        rows.append(row)
        print(f"  {row}", flush=True)

    for b, h, w, cin, cout, k, stride, pad in CONVS_B2 + CONVS_B16:
        x, wt, wq, ws, bias = cs._dynamic_operands(b, h, w, cin, cout, k, gen)
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        bound_ms, _ = cs.bound(2.0 * b * oh * ow * cout * k * k * cin,
                               2.0 * x.numel() + wq.numel() + 6.0 * cout + 2.0 * b * oh * ow * cout,
                               cs.H100_INT8_OPS)
        record("conv", (b, h, w, cin, cout, k, stride, pad),
               lambda: K.conv2d_int8_dynamic(x, wq, ws, bias, stride, pad),
               lambda: F.conv2d(xc, wc, bias, stride, pad), bound_ms)
        del x, wt, wq, ws, bias, xc, wc
    for r, c, n in DENSE_B2 + cs.DYNAMIC_DENSE_SHAPES_B16:
        x4, wt, wq, ws, bias = cs._dynamic_operands(r, 1, 1, c, n, 1, gen)
        x, w2, wq2 = x4.view(r, c), wt.view(n, c), wq.view(n, c)
        bound_ms, _ = cs.bound(2.0 * r * c * n, 2.0 * r * c + n * c + 6.0 * n + 2.0 * r * n,
                               cs.H100_INT8_OPS)
        record("dense", (r, c, n), lambda: int8_linear_dynamic(x, wq2, ws, bias),
               lambda: F.linear(x, w2, bias), bound_ms)
        del x4, wt, wq, ws, bias, x, w2, wq2
    routes = []
    from d3roma_tpu_torch.ops.kernels import conv2d as C
    for r, c, n in SMALL_DENSE if hasattr(C, "route_plan") else ():
        x4, _, wq, ws, bias = cs._dynamic_operands(r, 1, 1, c, n, 1, gen)
        want = K.conv2d_int8_dynamic_plain(x4.view(1, 1, r, c), wq, ws, bias, 1, 0, per_row=True)
        fns, row = {}, {"shape": [r, c, n]}
        for route in ("small", "rows"):
            plan = C.route_plan(route, 1, 1, r, c, n, 1, 1, 1, 0, K._build.sm_count(0))
            ints = C._dynamic_ints(plan, 1, 1, r, c, n, 1, 1, 1, 0)

            def fn(plan=plan, ints=ints, x=x4.view(1, 1, r, c), wq=wq, ws=ws, bias=bias):
                out = torch.empty((1, 1, r, n), dtype=torch.bfloat16, device="cuda")
                C._dynamic_launch(x, wq, ws, bias, out, plan, *ints)
                return out

            err = (fn().float() - want.float()).abs().max().item()
            if err != 0.0:
                raise AssertionError(f"{route} route at {(r, c, n)}: max abs err {err}")
            fns[route] = fn
            row[f"{route}_device_ops"] = cs.device_ops_per_call(fn)
        turns = [cs.time_in_turns(fns["small"], fns["rows"]) for _ in range(3)]
        row["small_ms"] = [t[0] for t in turns]
        row["rows_ms"] = [t[1] for t in turns]
        for route in ("small", "rows", "rows", "small"):
            row.setdefault(f"{route}_host_ms", []).append(host_ms(fns[route]))
            row.setdefault(f"{route}_device_span_ms", []).append(device_span_ms(fns[route]))
        routes.append(row)
        print(f"  route {row}", flush=True)
        del x4, wq, ws, bias, want, fns
    print(json.dumps({"label": args.label, "card": smi.splitlines()[0], "rows": rows,
                      "small_against_rows": routes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
