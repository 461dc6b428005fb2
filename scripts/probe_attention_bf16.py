#!/usr/bin/env python3
"""Build variants of the bf16 whole-row attention kernel and time them on a CUDA card.

    python3 scripts/probe_attention_bf16.py

Builds the kernel of d3roma_tpu_torch/csrc/attention_bf16_rows.cuh as it
is and in variants made by text edits of a copy of the header (without the
register fence that keeps the zeroing of O ahead of the first wgmma, with
other launch bounds, with the ring refilled after the scores), reads
ptxas's report of each (registers a thread, and whether it serialized the
wgmmas: its C7515 note), and times each with CUDA events on
random bf16 operands at the UNet's two sites (B2 N=M=3600 H5 and B2
N=M=920 H10, head width 64), after checking its output against the
variant "as built" (max abs difference).

Prints the card's name and power limit, then one JSON line per variant.
The variants are measurement aids only; nothing of the port uses them.
Builds go to d3roma_tpu_torch/_build/probe_bf16/ (git-ignored). Needs nvcc
and one card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from d3roma_tpu_torch.ops.kernels import _build  # noqa: E402

LAUNCHER = """#include "attention_bf16_rows.cuh"
extern "C" int run(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                   float scale, void* stream) {
  const long long s[3] = {(long long)N * H * 64, (long long)H * 64, 64};
  return (int)d3r::launch_mha_bf16((const d3r::bf16*)q, (const d3r::bf16*)k,
                                   (const d3r::bf16*)v, (d3r::bf16*)o, B, N, N, H, 64, s, s, s,
                                   scale, (cudaStream_t)stream);
}
"""

REFILL = "    if (t > 0 && t - 1 + S < n_tiles && lt == 0) load_tile(t - 1 + S);\n"
WAIT0 = "    sm90::wgmma_wait<0>();\n    sm90::fence_sums(s);\n"
# variant -> [(text in the header, its replacement), ...]; each must match once
EDITS = {
    "as built": [],
    "no fence after O's zeros": [("  sm90::fence_sums(o);\n  float m_run", "  float m_run")],
    "min blocks 1": [("kMinBlocks = DP == 64 ? 3 : 1", "kMinBlocks = 1")],
    "refill after S": [(REFILL + WAIT0, WAIT0 + REFILL)],
}
SITES = ((2, 3600, 5), (2, 920, 10))


def build_variants(out: Path):
    header = (_build.CSRC_DIR / "attention_bf16_rows.cuh").read_text()
    procs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its edit no longer matches the header")
            text = text.replace(old, new)
        vdir = out / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "attention_bf16_rows.cuh").write_text(text)
        (vdir / "probe.cu").write_text(LAUNCHER)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(vdir), "-I", str(_build.CSRC_DIR),
               "-o", str(vdir / "libprobe.so"), str(vdir / "probe.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), vdir)
    libs, reports = {}, {}
    for name, (proc, vdir) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            reports[name] = {"build": "failed", "log": log[-2000:]}
            continue
        # ptxas's report of mha_kernel<64>
        regs = re.search(r"entry function '[^']*mha_kernelILi64E[^\n]*\n(?:[^\n]*\n)*?"
                         r"[^\n]*Used (\d+) registers", log)
        reports[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "serialized": any("C7515" in ln and "mha_kernelILi64E" in ln
                              for ln in log.splitlines()),
        }
        lib = ctypes.CDLL(str(vdir / "libprobe.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                         ctypes.c_void_p]
        libs[name] = lib
    return libs, reports


def time_site(libs, b, n, h):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, n, h, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    ms, diff, ref = {}, {}, None
    for name, lib in libs.items():
        o = torch.empty_like(q)

        def call():
            err = lib.run(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, 0.125,
                          stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        if ref is None:
            ref = o.float().clone()
        diff[name] = (o.float() - ref).abs().max().item()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 50)
        ms[name] = sum(times) / len(times)
    return ms, diff


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_bf16: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs, reports = build_variants(_build.BUILD_DIR / "probe_bf16")
    sites = {f"B{b} N=M={n} H{h}": time_site(libs, b, n, h) for b, n, h in SITES}
    for name, rep in reports.items():
        row = {"variant": name, **rep}
        for site, (ms, diff) in sites.items():
            if name in ms:
                row[site] = {"ms": ms[name], "max_abs_diff": diff[name]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
