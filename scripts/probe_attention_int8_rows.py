#!/usr/bin/env python3
"""Split the int8 whole-row attention kernel's time into its parts on a CUDA card.

    python3 scripts/probe_attention_int8_rows.py

Builds the rows kernel of d3roma_tpu_torch/csrc/attention_int8_rows.cuh
(head width 64) as it is and in three variants made by text edits of a
copy of the header, and times each with CUDA events on random int8
operands at the UNet's two int8 attention sites (B2 N=M=3600 H5, B2
N=M=920 H10):

- "as built": the kernel;
- "__expf": the softmax's expf replaced by the fast __expf (how much the
  exponential's instructions cost);
- "no softmax arithmetic": P taken from the low bits of the scores, the
  denominator a count (the TMA, wgmma and synchronisation skeleton);
- "pass 1 only": the row-max pass alone.

Prints one JSON line per site (ms of each variant, the mean of 3 x 50
launches) after the card's name and power limit. The variants are
measurement aids only; nothing of the port uses them. Builds go to
d3roma_tpu_torch/_build/probe/ (git-ignored). Needs nvcc and one card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from d3roma_tpu_torch.ops.kernels import _build  # noqa: E402

LAUNCHER = """#include "attention_int8_rows.cuh"
extern "C" int run(const void* qq, const void* kq, const void* vt, const void* amax, void* o,
                   int B, int N, int M, int Mp, int H, float scale, void* stream) {
  const unsigned* am = (const unsigned*)amax;
  d3r::AttnArgs a{(const int8_t*)qq, (const int8_t*)kq, (const int8_t*)vt, am, am + B * H,
                  am + 2 * B * H, (__nv_bfloat16*)o, B, N, M, Mp, H, N, scale};
  return (int)d3r::launch_rows<64>(a, (cudaStream_t)stream);
}
"""

SOFTMAX = """        float p = expf(__fsub_rn(__fmul_rn(int_to_float(s[4 * j + 2 * r + e]), c), m[r]));
        if (kMask && sm90::frag_col(j, e) >= valid) p = 0.f;
        l[r] = __fadd_rn(l[r], p);
        q[e] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic));"""

# variant -> [(text in the header, its replacement), ...]; each must match once
EDITS = {
    "as built": [],
    "__expf": [("float p = expf(", "float p = __expf(")],
    "no softmax arithmetic": [(SOFTMAX, """        l[r] = __fadd_rn(l[r], 1.f);
        q[e] = (uint32_t)(s[4 * j + 2 * r + e] & 0x7F);""")],
    "pass 1 only": [
        ("for (int it = 0; it < 2 * n_tiles; ++it) {", "for (int it = 0; it < n_tiles; ++it) {"),
        ("  for (int t = 0; t < n_tiles; ++t) {\n    sm90::mbar_wait(&full[r.stage], r.phase);\n"
         "    const uint8_t* stage",
         "  for (int t = 0; t < 0; ++t) {\n    sm90::mbar_wait(&full[r.stage], r.phase);\n"
         "    const uint8_t* stage"),
        ("  if (lt == 0) sm90::mbar_arrive(&empty[prev]);\n\n  const float sv127",
         "  if (prev >= 0 && lt == 0) sm90::mbar_arrive(&empty[prev]);\n\n  const float sv127"),
    ],
}
SITES = ((2, 3600, 5), (2, 920, 10))
D = 64


def build_variants(out: Path):
    header = (_build.CSRC_DIR / "attention_int8_rows.cuh").read_text()
    procs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its edit no longer matches the header")
            text = text.replace(old, new)
        vdir = out / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "attention_int8_rows.cuh").write_text(text)
        (vdir / "probe.cu").write_text(LAUNCHER)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(vdir), "-I", str(_build.CSRC_DIR),
               "-o", str(vdir / "libprobe.so"), str(vdir / "probe.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), vdir)
    libs = {}
    for name, (proc, vdir) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(str(vdir / "libprobe.so"))
        lib.run.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                         ctypes.c_void_p]
        libs[name] = lib
    return libs


def time_site(libs, b, n, h):
    m, mp = n, -(-n // 64) * 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    qq, kq = (torch.randint(-127, 128, (b, n, h, D), dtype=torch.int8, device="cuda",
                            generator=gen) for _ in range(2))
    vt = torch.randint(-127, 128, (b, h, D, mp), dtype=torch.int8, device="cuda", generator=gen)
    vt[..., m:] = 0
    amax = torch.full((3 * b * h,), 3.0, device="cuda").view(torch.int32)
    o = torch.empty((b, n, h, D), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for name, lib in libs.items():
        def call():
            err = lib.run(qq.data_ptr(), kq.data_ptr(), vt.data_ptr(), amax.data_ptr(),
                          o.data_ptr(), b, n, m, mp, h, 0.125, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        for _ in range(5):
            call()
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
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention_int8_rows: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = build_variants(_build.BUILD_DIR / "probe")
    for b, n, h in SITES:
        print(json.dumps({"site": [b, n, n, h, D], "ms": time_site(libs, b, n, h)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
