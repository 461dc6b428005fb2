#!/usr/bin/env python3
"""Time the attention kernels of a tree of this repository on a CUDA card.

    python3 scripts/time_attention.py [--tree DIR] [--label NAME]

Imports d3roma_tpu_torch from DIR (default: this repository; its kernels
build from DIR's csrc/ at first use) and times its attention calls with
chip_smoke.py's helpers: CUDA events in turns with the library call (K L L
K), and torch.profiler for the device ms of one call by launch:

- mha_attention (bf16) at B2 N=M=3600 H5 D64 and B2 N=M=920 H10 D64,
  against F.scaled_dot_product_attention;
- fused_self_attention_bf16 at B2 N920 C640, against 4 F.linear + SDPA;
- mha_attention_int8 at the VAE's B2 (decode) and B4 (encode) N=M=3600 H1
  D512, against SDPA.

Inputs are random, seeded on the card. Prints the card's name and power
limit, then one JSON line. To compare two trees on one card, run it on both
in one session, in turns (parent, change, change, parent). Needs one card
and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
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
        raise SystemExit("time_attention: no CUDA device is available")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from d3roma_tpu_torch.ops import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"package {Path(K.__file__).resolve().parents[2]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2468)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def timed(kernel, library):
        ms, library_ms = cs.time_in_turns(kernel, library)
        host_ms, device_ms, by_op = cs.host_and_device_ms(kernel)
        return {"ms": ms, "library_ms": library_ms, "host_ms": host_ms, "device_ms": device_ms,
                "device_ms_by_launch": by_op}

    rows = []
    for b, n, h, d, fn in ((2, 3600, 5, 64, K.mha_attention), (2, 920, 10, 64, K.mha_attention),
                           (2, 3600, 1, 512, K.mha_attention_int8),
                           (4, 3600, 1, 512, K.mha_attention_int8)):
        q, k, v = (rnd(b, n, h, d) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"kernel": fn.__name__, "shape": [b, n, n, h, d]}
        row.update(timed(lambda: fn(q, k, v), lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        rows.append(row)
        print(f"  {row}", flush=True)
    b, n, c = 2, 920, 640
    x = rnd(b, n, c)
    ws = [rnd(c, c, scale=c ** -0.5) for _ in range(4)]
    bo = torch.randn((c,), generator=gen, device="cuda") * 0.1
    wqkv, bo16 = torch.cat(ws[:3]).contiguous(), bo.to(torch.bfloat16)

    def library():
        q, k, v = (F.linear(x, w).view(b, n, c // 64, 64).transpose(1, 2) for w in ws[:3])
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        return F.linear(o, ws[3], bo16)

    row = {"kernel": "fused_self_attention_bf16", "shape": [b, n, c, c // 64]}
    row.update(timed(lambda: K.fused_self_attention_bf16(x, wqkv, ws[3], bo, c // 64), library))
    rows.append(row)
    print(f"  {row}", flush=True)
    print(json.dumps({"label": args.label, "card": smi.splitlines()[0], "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
