#!/usr/bin/env python3
"""Time the activation quantize, the int8 ops that launch it, and the fused
GroupNorm + SiLU of a tree of this repository on a CUDA card.

    python3 scripts/time_quant_gn.py [--tree DIR] [--label NAME]

Imports d3roma_tpu_torch from DIR (default: this repository; its kernels
build from DIR's csrc/ at first use) and times, with chip_smoke.py's helpers
(CUDA events in turns with the library call, K L L K, where there is one;
torch.profiler for the device ms of one call by launch, each kernel's own
time; the device span of one call, first kernel's start to last one's end,
behind a sleep kernel; host ms to issue one call right after a
synchronize, the median of seven means):

- quantize_int8_scalar at B2 3600x320 (bf16);
- conv2d_int8, "xla" epilogue, at the UNet's B2 23x40 1920->640 3x3 and B2
  45x80 320->320 3x3 stride 2, the VAE's B4 360x640 128->128 3x3, and the
  int8 dense layers at 7200x320, 1840x640 and 480x1280 (PERF.md row 3),
  against F.conv2d / F.linear in bf16;
- geglu_ff_int8 at the UNet's four levels at batch 2 (row 2b);
- fused_self_attention_int8 at the UNet's four levels at batch 2 (row 7);
- group_norm_silu at the opt-in path's four timed sites (row 6), gamma and
  beta in bf16 as the models hold them, with its device ops a call, against
  F.silu(F.group_norm(x)).

Inputs are random, seeded on the card. Prints the card's name and power
limit, then one JSON line. To compare two trees on one card, run it on both
in one session, in turns (parent, change, change, parent). Needs one card
and nvcc.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("time_quant_gn: no CUDA device is available")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from d3roma_tpu_torch.ops import kernels as K
    from d3roma_tpu_torch.ops.quant import fp32, int8_linear, quantize_weight

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"package {Path(K.__file__).resolve().parents[2]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1357)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def act_of(x):
        return fp32(x.float().abs().max().item() * 1.25 / 127)

    rows = []

    def host_ms(fn, repeats=7, calls=20):
        """The median over `repeats` of the mean host ms to issue one of
        `calls` calls right after a synchronize (the host's clock varies
        more than the device's)."""
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
        """The device's span of one call, from its first kernel's start to its
        last one's end, gaps and overlaps between its launches included: a
        ~1 ms sleep kernel ahead of each call lets the host enqueue the whole
        call before the device reaches it; median of `reps` calls."""
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

    def record(kernel, shape, fn, library=None, **extra):
        row = {"kernel": kernel, "shape": list(shape), **extra}
        if library is None:
            row["ms"] = cs.time_ms(fn)
            row["library_ms"] = None
        else:
            row["ms"], row["library_ms"] = cs.time_in_turns(fn, library)
        _, row["device_ms"], row["device_ms_by_launch"] = cs.host_and_device_ms(fn)
        row["host_ms"] = host_ms(fn)
        row["device_span_ms"] = device_span_ms(fn)
        row["device_ops_per_call"] = cs.device_ops_per_call(fn)
        rows.append(row)
        print(f"  {row}", flush=True)

    x = rnd(2, 3600, 320)
    act = act_of(x)
    record("quantize_int8_scalar", x.shape, lambda: K.quantize_int8_scalar(x, act))

    for b, h, w, cin, cout, k, stride, pad in ((2, 23, 40, 1920, 640, 3, 1, 1),
                                               (2, 45, 80, 320, 320, 3, 2, 1),
                                               (4, 360, 640, 128, 128, 3, 1, 1)):
        x = rnd(b, h, w, cin)
        wt = rnd(cout, k, k, cin, scale=(k * k * cin) ** -0.5)
        wq, ws = quantize_weight(wt)
        bias = rnd(cout, scale=0.1)
        act = act_of(x)
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        record("conv2d_int8", (b, h, w, cin, cout, k, stride, pad),
               lambda: K.conv2d_int8(x, wq, ws, act, bias, stride, pad),
               lambda: F.conv2d(xc, wc, bias, stride, pad), epilogue="xla")
    for n, c in ((7200, 320), (1840, 640), (480, 1280)):
        x = rnd(2, n // 2, c)
        wt = rnd(c, c, scale=c ** -0.5)
        wq, ws = quantize_weight(wt)
        bias = rnd(c, scale=0.1)
        act = act_of(x)
        record("conv2d_int8 (dense)", (n, c, c), lambda: int8_linear(x, wq, ws, act, bias),
               lambda: F.linear(x, wt, bias), epilogue="xla")

    for n, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280)):
        x = rnd(1, 2 * n, c)
        ops_in = cs._int8_ff_operands(c, 4 * c, gen)
        act = act_of(x)
        record("geglu_ff_int8", (2 * n, c, 4 * c), lambda: K.geglu_ff_int8(x, *ops_in, act))

    for n, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280)):
        x = rnd(2, n, c)
        ops_in, ws4 = cs._fused_attention_operands(c, gen)
        heads, act = c // 64, act_of(x)
        bo16 = ops_in[3].to(torch.bfloat16)

        def library():
            q, k, v = (F.linear(x, w).view(2, n, heads, 64).transpose(1, 2) for w in ws4[:3])
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(2, n, c)
            return F.linear(o, ws4[3], bo16)

        record("fused_self_attention_int8", (2, n, c),
               lambda: K.fused_self_attention_int8(x, *ops_in, heads, act), library)

    for shape in cs.GN_SHAPES:
        x = (rnd(*shape) * 2 + 0.5).to(torch.bfloat16)
        c = shape[-1]
        gamma, beta = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
        xc = x.permute(0, 3, 1, 2)
        bound_ms, bound_by = cs.bound(0.0, 2.0 * x.numel() * 2 + 4.0 * c)
        record("group_norm_silu", shape, lambda: K.group_norm_silu(x, gamma, beta, 32, 1e-5),
               lambda: F.silu(F.group_norm(xc, 32, gamma, beta, 1e-5)), bound_ms=bound_ms,
               bound_by=bound_by)
        rows[-1]["bound_share_of_device"] = bound_ms / rows[-1]["device_ms"]
    print(json.dumps({"label": args.label, "card": smi.splitlines()[0], "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
