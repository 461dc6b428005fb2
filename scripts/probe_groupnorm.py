#!/usr/bin/env python3
"""Time the fused GroupNorm + SiLU kernel (csrc/groupnorm_silu.cu) on a CUDA
card under every plan its host planner considers, at the opt-in path's four
timed shapes.

    python3 scripts/probe_groupnorm.py [--out FILE]

For each shape: the planner's choice (gn_plan), then every resident plan of
the same search (groups a band, cluster size) and the GroupNorm alone (no
SiLU) under the chosen plan, each by its device time a call
(chip_smoke.host_and_device_ms: torch.profiler's kernel times; back-to-back
CUDA events would time the wrapper's host work at these sizes), beside a
clone of x (the bytes' yardstick: one read and one write). Prints the
card's name and power limit and one JSON line per shape. Needs one card and
nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_groupnorm: no CUDA device is available")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from d3roma_tpu_torch.ops.kernels import groupnorm as kgn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(97)
    planner = kgn.gn_plan
    lines = []
    for shape in cs.GN_SHAPES:
        b, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        gamma = torch.ones(c, device="cuda", dtype=torch.bfloat16)
        beta = torch.zeros(c, device="cuda", dtype=torch.bfloat16)
        chosen = planner(b, h * w, c, 32, 2, sms)
        cg = c // 32
        plans = [chosen]
        for k in range(8 // math.gcd(cg, 8), 33, 8 // math.gcd(cg, 8)):
            if 32 % k:
                continue
            for cl in kgn.CLUSTER_SIZES[:4]:
                per = -(-h * w // cl)
                smem = kgn.gn_smem_bytes(per, k * cg, k, 2, True)
                if (cl - 1) * per < h * w and smem <= kgn.MAX_SMEM_BYTES:
                    plans.append(kgn.GnPlan(k, k * cg, 32 // k, cl, per, True, smem,
                                            b * (32 // k) * cl))
        rows = []
        for i, plan in enumerate(plans):
            kgn.gn_plan = lambda *a, _p=plan, **kw: _p
            kgn._launch_args.cache_clear()
            silu_variants = (True, False) if i == 0 else (True,)
            for silu in silu_variants:
                _, device_ms, _ = cs.host_and_device_ms(
                    lambda: kgn.group_norm_silu(x, gamma, beta, 32, 1e-5, silu))
                rows.append({"plan": dataclasses.asdict(plan), "silu": silu,
                             "device_ms": device_ms, "chosen": i == 0})
        kgn.gn_plan = planner
        kgn._launch_args.cache_clear()
        line = {"shape": list(shape), "clone_device_ms": cs.host_and_device_ms(x.clone)[1],
                "rows": rows}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text(json.dumps({"card": smi.splitlines()[0], "shapes": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
