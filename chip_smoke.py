#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --geglu    # device, build and the two GEGLU kernels' cases only
    python3 chip_smoke.py --conv     # device, build and the conv kernels' cases only
    python3 chip_smoke.py --winograd # device, build and the Winograd kernel's cases only
    python3 chip_smoke.py --attention  # device, build and the attention cases only (bf16
                                       # and int8, whole-row and fused)
    python3 chip_smoke.py --quant    # device, build, the quantize kernel's cases and the
                                     # int8 consumers' back-to-back (PDL race) cases only
    python3 chip_smoke.py --groupnorm  # device, build and the fused GroupNorm's cases only
    python3 chip_smoke.py --dynamic  # device, build and the dynamic int8 conv's cases only
    python3 chip_smoke.py --pixel    # device, build, the pixel phase and the pixel bench only

Run from the repository root, on a machine with a CUDA GPU and nvcc (the
kernels build from d3roma_tpu_torch/csrc/ at first use). Phases, each
failing the run on its own error:

1. device: require CUDA; print the card's name and power limit, and its
   maximum SM clock (the exponentials' bound of the attention rows);
2. build: compile the kernels, one nvcc per source, all at once;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main paths' shapes and a few ragged ones, with the stated tolerance;
   time kernel, plain version and one library call, and compute the bound
   (bf16 peak for the bf16 kernels, int8 peak for the int8 ones); the int8
   conv kernel in each of its three epilogues through the JAX entry points
   (conv3x3_flat, conv3x3_rowtap, conv3x3_halo), bit-equal, and at the
   int8 dense layers' shapes; the two GEGLU kernels at the UNet's four
   levels at batch 2 and 16, the int8 one bit-equal; the GEGLU, conv and
   dense cases and the bf16 fused attention timed in turns with their
   library call (K L L K), with their host and device ms per call and the
   host plan of the call; every int8 op that quantizes its input in its own
   launch (the int8 conv in each epilogue, split and not, the int8 dense,
   the int8 GEGLU, the fused int8 attention, and the dynamic int8 conv and
   dense, whose scales the call computes on the device, on each of its four
   routes) run back to back on two distinct inputs after a third, through
   the one reused int8 workspace, both results bit-equal to the plain
   version (a consumer that read the workspace before its quantize finished
   would return the input before's result); the dynamic int8 conv and dense
   bit-equal at the "all" path's batch-2 conv and dense shapes (timed), at
   the batch-16 dense shapes and ragged and all-zero ones, the 1x1 and
   stride-2 convolutions on both the loader-quantize and the separate
   route, convolutions of 130 and 300 batch items (launched in chunks of at
   most 128), each case at the device ops its plan states and with no
   memset; the fused GroupNorm at one device op a call, bit-identical
   across two calls, within tolerance of its plain version at the opt-in
   path's shapes, the gate's 4 MiB edge and ragged ones, with its plan;
4. latency path: GuidedLatentDiffusionPipeline.fast_inference("latency")
   at the full SD2.1 geometry (random seeded weights held in bf16), batch
   2, RGB + raw at 640x360, 10 DDIM steps; the launch counts of one call
   must be 100 attention and 160 GEGLU; ms/frame is the median of three
   calls; one more call is profiled (device time by kernel group, idle
   share); one UNet forward with the kernels must agree with the same
   forward through the plain torch paths;
5. latency-fused path on the same models: the same with the fused
   self-attention (set_kernels(use_flash_attention="fused")); the launch
   counts of one call must be 50 bf16 fused attention (the 920-token
   sites), 50 whole-row bf16 attention (the 3600-token sites' flash route)
   and 160 GEGLU; ms/frame, the profile, and one UNet forward through the
   kernels against the same forward through their plain versions;
6. bench-default path on the same models: fast_inference("throughput")
   (static int8), deepcache(2, depth=2), calibrate on one batch; the launch
   counts of one call must be 102 int8 attention, 130 int8 GEGLU and one
   int8 conv per quantized conv site the capture logs list; ms/frame, the
   profile, and one full and one shallow UNet forward through the int8
   kernels against the same forwards through the kernels' plain versions;
7. conv routes on the bench default's calibrated models: set_quant("halo"),
   then set_quant("mxu"); a dry pass logs each conv's route; the int8 conv
   launches of one call must split into the mode's epilogue (the gate's
   sites) and the static one, summing to the bench default's count, with
   the bench default's attention, GEGLU and quantize counts; ms/frame, the
   profile and the full and shallow forwards as in phase 6;
8. dynamic and Winograd paths on the same models (the JAX bench's
   BENCH_QUANT=1, dense and wino), the bench's kernels and deepcache(2,
   depth=2), no calibration: launch counts of one call (the dynamic int8
   conv kernel once per dense and conv visit, two per feed-forward; the
   int8 whole-row attention under "all", 102; the bf16 one under "dense"
   and "wino", 100; under "wino" the Winograd kernel at every visit a dry
   pass routes to Winograd), one "all" call under
   torch.cuda.set_sync_debug_mode("error") (no host synchronization),
   ms/frame, the profile and the full and shallow UNet forwards through the
   kernels against their plain versions;
9. vae8 on the same models: a float UNet and a static VAE, calibrated
   (which makes the UNet static, as in the JAX package): the bench
   default's launch counts from this calibration's logs, ms/frame, the
   forwards;
10. opt-in path on the same models: fast_inference("wino").fuse_norms(), the
   fused self-attention (set_kernels(use_flash_attention="fused")),
   deepcache(2, depth=2), calibrate on one batch; a dry pass logs the
   port's routing (Winograd or static int8 per conv, fused GroupNorm or not
   per norm); the launch counts of one call must be 130 fused attention,
   2 int8 whole-row attention (the VAE's), 130 int8 GEGLU, one int8 conv per
   conv or dense site of the capture logs and the Winograd and fused
   GroupNorm calls of the dry pass; ms/frame, the profile, and one full and
   one shallow UNet forward through the kernels against their plain versions;
11. pixel path: GuidedDiffusionPipeline at the JAX bench's pixel setting
    (UNet2D at its full widths, random seeded weights in bf16, my_ddpm over
    128 squaredcos steps, SSI normalizer), batch 2, RGB + raw at 368x640
    (360 padded to a multiple of 16), 10 steps, 5 intermediates, the raw
    condition SSI-normalized on the card: shapes, finite output in [-1, 1],
    no hand kernel launched (head dim 8, no transformer), ms/frame (median
    of three calls), peak memory, the profile; SSI denormalize (least
    squares, and RANSAC with explicit subsets) on the card against the CPU;
    one bf16 UNet2D forward against the same weights in fp32; on a copy
    fuse_norms() alone, one bf16 UNet2D forward through the fused
    GroupNorm against its plain version; then on a copy
    quantize_int8().fuse_norms(): a dry pass logs each site's route, the
    fused GroupNorm is held against its plain version at every shape it
    admits, and one call must launch the dynamic int8 conv once per conv
    and dense visit and the fused GroupNorm once per norm its gate admits,
    nothing else; ms/frame, the profile, and one UNet2D forward through the
    kernels against their plain versions;
12. the torch bench, `python -m d3roma_tpu_torch.bench`, in its own process
    at batch 2 with 3 timed calls (records and scales in a temporary
    directory), at the default setting, at BENCH_CLIP_PCT=0.999 and at
    BENCH_MODEL=pixel: its JSON line must carry every key of the JAX
    bench's at that setting, value > 0;
13. a JSON line of per-kernel numbers, then the JSON result as the last line.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
# exponentials a clock on one SM (the SFU's ex2 rate, Hopper's 16 a clock
# per SM); times the SM count and the maximum SM clock read by device_phase
EXP_PER_CLOCK_PER_SM = 16
_CARD = {"max_sm_clock_mhz": None}
# Kernels against their plain versions: max |err| <= REL_TOL * max |ref|.
# bf16 rounding of the output (2^-9 relative) and of P or of the gated
# product keeps the measured ratio near 4e-3 for the bf16 kernels; the int8
# attention differs by one bf16 rounding of its output (its denominator sums
# in another order), and the int8 GEGLU, conv and quantize kernels are
# bit-equal to their plain versions. An error of a few percent anywhere (a
# denominator, a rescale, a scale grid, a bias) exceeds it.
REL_TOL = 1e-2
UNET_REL_TOL = 5e-2  # kernel path vs plain path, max error / max |output|
H, W = 360, 640
BATCH = 2
STEPS = 10


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def exp_rate() -> float:
    """Exponentials a second the card's SFUs can take at its maximum SM
    clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_PER_SM * sms * _CARD["max_sm_clock_mhz"] * 1e6


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS, exps: float = 0.0):
    """Least time on the card (ms) and what sets it: the largest of the
    operations over `peak` (bf16, or H100_INT8_OPS for the int8 kernels), the
    bytes over the memory rate and, for a softmax, its `exps` exponentials
    over the SFUs' rate."""
    times = {"operations": flops / peak * 1e3, "bytes": nbytes / H100_BYTES_PER_S * 1e3}
    if exps:
        times["exponentials"] = exps / exp_rate() * 1e3
    by = max(times, key=times.get)
    return times[by], by


def _check_row(name, row, err, tol):
    """Print a kernel case's row; fail it when its error exceeds its tolerance."""
    _sync()
    print(f"  {name} {row}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {row['shape']}: max abs err {err} > {tol}")
    return row


def pin_one_card() -> None:
    """Make the script see exactly one card, the first of those visible."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]


def device_phase() -> str:
    """Require one CUDA card; print and return its name and power limit."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"chip_smoke: {torch.cuda.device_count()} cards visible, want 1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    _CARD["max_sm_clock_mhz"] = float(clock.splitlines()[0])
    print(f"max SM clock {_CARD['max_sm_clock_mhz']:.0f} MHz", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    return smi.splitlines()[0]


def build_phase() -> None:
    from d3roma_tpu_torch.ops.kernels import KERNEL_SOURCES, _build

    t0 = time.perf_counter()
    secs = _build.build(KERNEL_SOURCES)
    print(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"wall {time.perf_counter() - t0:.1f}s", flush=True)
    for name in KERNEL_SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "registers" in ln or "spill" in ln or "entry function" in ln:
                    print(f"  ptxas {name}: {ln.strip()}", flush=True)


def _attention_case(b, n, m, h, d, gen, timed, layout="contiguous"):
    """The bf16 whole-row attention against its plain version. layout:
    "contiguous" q, k, v [B, L, H, D]; "workspace", q, k and v read in
    place from one [B, N, 3 H D] projection (M = N), as the fused bf16
    attention reads them; "padded", heads D + 16 apart; "transposed",
    [B, H, L, D] tensors seen as [B, L, H, D] (strides a TMA map cannot
    take: the wrapper copies them first)."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import attention as kattn
    from d3roma_tpu_torch.ops.kernels import mha_attention, mha_attention_plain

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if layout == "workspace":
        w = rnd(b, n, 3 * h * d).view(b, n, 3, h, d)
        q, k, v = w[:, :, 0], w[:, :, 1], w[:, :, 2]
    elif layout == "padded":
        q, k, v = (rnd(b, length, h, d + 16)[..., :d] for length in (n, m, m))
    elif layout == "transposed":
        q, k, v = (rnd(b, h, length, d).transpose(1, 2) for length in (n, m, m))
    else:
        q, k, v = (rnd(b, length, h, d) for length in (n, m, m))
    out = mha_attention(q, k, v)
    ref = mha_attention_plain(q.float(), k.float(), v.float())
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    strides = [kattn.tma_head_strides(t.shape, t.stride()) for t in (q, k, v)]
    plan = kattn.bf16_plan(b, n, m, h, d, *strides)
    row = {"shape": [b, n, m, h, d], "layout": layout, "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item(),
           "plan": {"width": plan.width, "stages": plan.stages, "grid": list(plan.grid),
                    "smem_bytes": plan.smem_bytes}}
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * b * h * n * m * d
        nbytes = 2.0 * (2 * b * n * h * d + 2 * b * m * h * d)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, exps=float(b * h * n * m))
        _timed_against_library(row, lambda: mha_attention(q, k, v),
                               lambda: F.scaled_dot_product_attention(qt, kt, vt), split=True)
        row["plain_ms"] = time_ms(lambda: mha_attention_plain(q, k, v), reps=5)
        row["library_call"] = "F.scaled_dot_product_attention (bf16)"
    return _check_row("attention", row, err, tol)


def attention_bf16_cases(gen):
    """The bf16 whole-row attention at the latency path's shapes (timed) and
    ragged and strided ones (checked only): N and M off the 64- and 128-row
    blocks and the 128-key tiles, M = 1, head widths under and over the
    64-column box, q, k, v read through their strides."""
    rows = [_attention_case(BATCH, 3600, 3600, 5, 64, gen, True),
            _attention_case(BATCH, 920, 920, 10, 64, gen, True)]
    for shape in ((1, 600, 600, 2, 64), (2, 300, 77, 3, 32), (1, 100, 130, 2, 128),
                  (1, 70, 50, 1, 48), (1, 129, 1, 1, 96), (3, 70, 700, 1, 16)):
        _attention_case(*shape, gen, False)
    for shape, layout in (((2, 200, 200, 3, 64), "workspace"), ((2, 920, 920, 10, 64), "workspace"),
                          ((1, 300, 250, 2, 80), "padded"), ((1, 140, 300, 4, 64), "transposed")):
        _attention_case(*shape, gen, False, layout)
    return rows


def time_in_turns(kernel, library):
    """Kernel and library call timed in turns (K L L K): the mean ms of
    each."""
    k1, l1, l2, k2 = (time_ms(fn) for fn in (kernel, library, library, kernel))
    return (k1 + k2) / 2, (l1 + l2) / 2


def _plan_fields(rows, c, f, int8):
    from d3roma_tpu_torch.ops.kernels import _build, geglu

    plan = geglu.geglu_plan(rows, c, f, int8, _build.sm_count(0))
    return {"gate_cols": geglu.GATE_COLS, "out_cols": plan.out_cols, "splits": plan.splits,
            "workspace_mb": plan.workspace_bytes / 1e6}


def _conv_plan_fields(b, h, w, cin, cout, k, stride, padding, itemsize, epilogue):
    import torch

    from d3roma_tpu_torch.ops.kernels import conv2d

    plan, _ = conv2d.launch_ints(b, h, w, cin, cout, k, k, stride, padding, itemsize, epilogue,
                                 False, torch.device("cuda", 0))
    return {"box": list(plan.box), "bn": plan.bn, "splits": plan.splits,
            "workspace_mb": plan.workspace_bytes / 1e6}


def host_and_device_ms(fn, calls: int = 20):
    """Host time to issue one call of fn (the mean over `calls` issued right
    after a synchronize: too few for the launch queue to fill, so the device
    never holds the host back), device time of one call (its kernels' time
    summed by torch.profiler) and that time by device op (kernel or memset
    name -> ms a call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    _sync()
    for _ in range(2):  # the first session of a process can miss early kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            _sync()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            split[evt.key[:80]] = split.get(evt.key[:80], 0.0) + us / calls / 1e3
    return host_ms, sum(split.values()), split


def device_ops_per_call(fn, calls: int = 10, sessions: int = 3) -> float:
    """Device operations (kernels, memsets, copies) one call of fn runs, as
    torch.profiler counts them over `calls` calls: the most of `sessions`
    sessions, since a session can miss a kernel (one of ten GroupNorm
    launches once went uncounted) but never counts one that did not run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    counts = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            _sync()
        counts.append(sum(evt.count for evt in prof.key_averages()
                          if getattr(evt, "device_type", None)
                          == torch.autograd.DeviceType.CUDA) / calls)
    return max(counts)


def _timed_against_library(row, kernel, library, split=False):
    """ms and library_ms in turns, their ratio, the bound's share of ms, and
    the kernel's host and device ms per call (ms is about the larger); with
    `split`, the device ms of each of the call's device ops too."""
    row["ms"], row["library_ms"] = time_in_turns(kernel, library)
    row["ratio_to_library"] = row["ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["host_ms"], row["device_ms"], by_op = host_and_device_ms(kernel)
    if split:
        row["device_ms_by_launch"] = by_op


def _geglu_case(rows, c, f, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import geglu_ff, geglu_ff_plain

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = rnd(1, rows, c).to(torch.bfloat16)
    # K-major weights, as FeedForward hands them over: transposed views
    w1h_t, w1g_t = (rnd(f, c, scale=c ** -0.5).to(torch.bfloat16) for _ in range(2))
    w2_t = rnd(c, f, scale=f ** -0.5).to(torch.bfloat16)
    w1h, w1g, w2 = w1h_t.t(), w1g_t.t(), w2_t.t()
    b1h, b1g, b2 = rnd(f, scale=0.1), rnd(f, scale=0.1), rnd(c, scale=0.1)
    out = geglu_ff(x, w1h, w1g, w2, b1h, b1g, b2)
    ref = geglu_ff_plain(x.float(), w1h.float(), w1g.float(), w2.float(), b1h, b1g, b2)
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [rows, c, f], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item(), **_plan_fields(rows, c, f, False)}
    if timed:
        w1 = torch.cat([w1h_t, w1g_t]).contiguous()
        b1 = torch.cat([b1h, b1g]).to(torch.bfloat16)
        b2l = b2.to(torch.bfloat16)

        def library():
            hh, gg = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(hh * F.gelu(gg, approximate="tanh"), w2_t, b2l)

        flops = 6.0 * rows * c * f
        nbytes = 2.0 * (2 * rows * c + 3 * c * f) + 4.0 * (2 * f + c)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        _timed_against_library(row, lambda: geglu_ff(x, w1h, w1g, w2, b1h, b1g, b2), library)
        row["plain_ms"] = time_ms(lambda: geglu_ff_plain(x, w1h, w1g, w2, b1h, b1g, b2),
                                  reps=5)
        row["library_call"] = "F.linear(x, W1) -> gelu -> F.linear(y, W2) (bf16)"
    return _check_row("geglu", row, err, tol)


# (rows, C, F) of the UNet's four levels (3600, 920, 240, 60 tokens) at
# batch 2, then at the benchmark's batch 16
GEGLU_SHAPES = tuple((bt * t, c, 4 * c) for bt in (BATCH, 16)
                     for t, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280)))


def geglu_cases(gen):
    """The bf16 GEGLU at its flagship shapes (timed) and ragged ones."""
    rows = [_geglu_case(*shape, gen, True) for shape in GEGLU_SHAPES]
    for shape in ((100, 64, 256), (33, 1280, 5120), (7, 32, 128), (50, 1920, 7680)):
        _geglu_case(*shape, gen, False)
    return rows


def geglu_int8_cases(gen):
    """The int8 GEGLU at its flagship shapes (timed) and ragged ones."""
    rows = [_geglu_int8_case(*shape, gen, True) for shape in GEGLU_SHAPES]
    for shape in ((100, 64, 256), (33, 1280, 5120), (300, 320, 1280), (50, 1920, 7680),
                  (1000, 640, 2560)):
        _geglu_int8_case(*shape, gen, False)
    return rows


def kernel_phase():
    """Each kernel against its plain version: the flagship shapes (timed) and
    ragged ones that exercise the masked edges (checked only)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    attn = attention_bf16_cases(gen)
    geglu = geglu_cases(gen)
    _sync()
    return attn, geglu


def _attention_int8_case(b, n, m, h, d, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import attention as kattn
    from d3roma_tpu_torch.ops.kernels import mha_attention_int8, mha_attention_int8_plain

    q, k, v = (torch.randn((b, length, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for length in (n, m, m))
    out = mha_attention_int8(q, k, v)
    ref = mha_attention_int8_plain(q, k, v).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, n, m, h, d], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item()}
    if d in kattn.WIDE_HEAD_DIMS:
        plan = kattn.wide_plan(b, n, m, h, d, -(-m // 64) * 64)
        row["plan"] = {"grid": list(plan.grid), "groups": plan.groups, "threads": plan.threads,
                       "slots": plan.slots, "smem_bytes": plan.smem_bytes}
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ops = 4.0 * b * h * n * m * d
        nbytes = 2.0 * (2 * b * n * h * d + 2 * b * m * h * d)
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS,
                                                 exps=float(b * h * n * m))
        _timed_against_library(row, lambda: mha_attention_int8(q, k, v),
                               lambda: F.scaled_dot_product_attention(qt, kt, vt), split=True)
        row["plain_ms"] = time_ms(lambda: mha_attention_int8_plain(q, k, v), reps=3, warmup=1)
        row["library_call"] = "F.scaled_dot_product_attention (bf16)"
    return _check_row("attention_int8", row, err, tol)


def _int8_ff_operands(c, f, gen):
    import torch

    from d3roma_tpu_torch.ops.quant import quantize_weight

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    w1h, w1g = (rnd(f, c, scale=c ** -0.5).to(torch.bfloat16) for _ in range(2))
    w2 = rnd(c, f, scale=f ** -0.5).to(torch.bfloat16)
    (w1hq, s1h), (w1gq, s1g), (w2q, s2) = (quantize_weight(w) for w in (w1h, w1g, w2))
    return w1hq, w1gq, w2q, s1h, s1g, s2, rnd(f, scale=0.1), rnd(f, scale=0.1), rnd(c, scale=0.1)


def _geglu_int8_case(rows, c, f, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import geglu_ff_int8, geglu_ff_int8_plain
    from d3roma_tpu_torch.ops.quant import fp32, quantize_int8

    x = torch.randn((1, rows, c), generator=gen, device="cuda").to(torch.bfloat16)
    ops_in = _int8_ff_operands(c, f, gen)
    act = fp32(x.float().abs().max().item() * 1.25 / 127)
    out = geglu_ff_int8(x, *ops_in, act)
    ref = geglu_ff_int8_plain(x, *ops_in, act).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    # bit-equal: the kernels take the plain version's fp32 operations in its
    # order, and the int32 sums are exact
    row = {"shape": [rows, c, f], "max_abs_err": err, "tol": 0.0,
           "max_abs_out": ref.abs().max().item(), **_plan_fields(rows, c, f, True)}
    if timed:
        w1hq, w1gq, w2q = ops_in[:3]
        w1t = torch.cat([w1hq, w1gq]).t()  # [C, 2F], column-major
        w2t = w2q.t()                      # [F, C], column-major
        xq = quantize_int8(x.reshape(rows, c), act)

        def library():
            hg = torch._int_mm(xq, w1t).float()
            y = hg[:, :f] * F.gelu(hg[:, f:], approximate="tanh")
            return torch._int_mm(y.to(torch.int8), w2t)

        ops = 6.0 * rows * c * f
        nbytes = 2.0 * 2 * rows * c + 3.0 * c * f + 4.0 * (4 * f + 2 * c)
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        _timed_against_library(row, lambda: geglu_ff_int8(x, *ops_in, act), library)
        row["plain_ms"] = time_ms(lambda: geglu_ff_int8_plain(x, *ops_in, act), reps=3,
                                  warmup=1)
        row["library_call"] = "torch._int_mm(xq, W1) -> gelu -> torch._int_mm(y, W2)"
    return _check_row("geglu_int8", row, err, 0.0)


def _conv_int8_case(b, h, w, cin, cout, k, stride, padding, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_int8, conv2d_int8_plain
    from d3roma_tpu_torch.ops.kernels.conv2d import conv_out_hw
    from d3roma_tpu_torch.ops.quant import fp32, quantize_weight

    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((cout, k, k, cin), generator=gen, device="cuda")
          * (k * k * cin) ** -0.5).to(torch.bfloat16)
    bias = (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    wq, ws = quantize_weight(wt)
    act = fp32(x.float().abs().max().item() * 1.25 / 127)
    out = conv2d_int8(x, wq, ws, act, bias, stride, padding)
    ref = conv2d_int8_plain(x, wq, ws, act, bias, stride, padding).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    # bit-equal: exact int32 sums, the plain version's fp32 operations
    row = {"shape": [b, h, w, cin, cout, k, stride, padding], "max_abs_err": err, "tol": 0.0,
           "max_abs_out": ref.abs().max().item(),
           **_conv_plan_fields(b, h, w, cin, cout, k, stride, padding, 1, "xla")}
    if timed:
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        wc = wt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        oh, ow = conv_out_hw(h, w, k, stride, padding)
        ops = 2.0 * b * oh * ow * cout * k * k * cin
        nbytes = 2.0 * b * h * w * cin + 1.0 * cout * k * k * cin + 6.0 * cout + 2.0 * b * oh * ow * cout
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        _timed_against_library(row, lambda: conv2d_int8(x, wq, ws, act, bias, stride, padding),
                               lambda: F.conv2d(xc, wc, bias, stride, padding))
        row["plain_ms"] = time_ms(
            lambda: conv2d_int8_plain(x, wq, ws, act, bias, stride, padding), reps=3, warmup=1)
        row["library_call"] = "F.conv2d (bf16, cuDNN, channels_last)"
    return _check_row("conv2d_int8", row, err, 0.0)


def _dense_int8_case(rows, c, n, gen, timed):
    """An int8 dense layer (ops/quant.py::int8_linear: the int8 conv kernel
    as a 1x1 convolution over the rows, "xla" epilogue) against the
    kernel's plain version: bit-equal."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_int8_plain
    from d3roma_tpu_torch.ops.quant import fp32, int8_linear, quantize_weight

    x = torch.randn((BATCH, rows // BATCH, c), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((n, c), generator=gen, device="cuda") * c ** -0.5).to(torch.bfloat16)
    bias = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    wq, ws = quantize_weight(wt)
    act = fp32(x.float().abs().max().item() * 1.25 / 127)
    out = int8_linear(x, wq, ws, act, bias)
    ref = conv2d_int8_plain(x.reshape(1, 1, rows, c), wq.view(n, 1, 1, c), ws, act, bias, 1,
                            0).reshape(out.shape).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    row = {"shape": [rows, c, n], "site": "dense", "max_abs_err": err, "tol": 0.0,
           "max_abs_out": ref.abs().max().item(),
           **_conv_plan_fields(1, 1, rows, c, n, 1, 1, 0, 1, "xla")}
    if timed:
        ops = 2.0 * rows * c * n
        nbytes = 2.0 * rows * c + 1.0 * n * c + 6.0 * n + 2.0 * rows * n
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        _timed_against_library(row, lambda: int8_linear(x, wq, ws, act, bias),
                               lambda: F.linear(x, wt, bias))
        row["plain_ms"] = time_ms(lambda: conv2d_int8_plain(
            x.reshape(1, 1, rows, c), wq.view(n, 1, 1, c), ws, act, bias, 1, 0), reps=3,
            warmup=1)
        row["library_call"] = "F.linear (bf16)"
    return _check_row("conv2d_int8 (dense)", row, err, 0.0)


def conv_int8_cases(gen):
    """The int8 conv kernel in its "xla" epilogue at the bench-default
    path's conv and dense shapes (timed) and ragged ones (checked only)."""
    rows = [
        _conv_int8_case(BATCH, 23, 40, 1920, 640, 3, 1, 1, gen, True),   # UNet up block 2
        _conv_int8_case(2 * BATCH, H, W, 128, 128, 3, 1, 1, gen, True),  # VAE encoder
        _conv_int8_case(2 * BATCH, H + 1, W + 1, 128, 128, 3, 2, 0, gen, True),  # VAE down
        _conv_int8_case(BATCH, H, W, 256, 128, 1, 1, 0, gen, True),      # VAE 1x1 shortcut
        _conv_int8_case(BATCH, 45, 80, 320, 320, 3, 2, 1, gen, True)]    # UNet downsampler
    # the dense layers of the UNet's three transformer widths (batch 2)
    rows += [_dense_int8_case(r, c, c, gen, True) for r, c in ((7200, 320), (1840, 640),
                                                                (480, 1280))]
    for shape in ((1, 7, 9, 32, 64, 3, 1, 1), (1, 5, 6, 64, 96, 3, 2, 1),
                  (2, 9, 11, 32, 130, 1, 1, 0), (1, 13, 17, 96, 34, 3, 2, 0),
                  (BATCH, 6, 10, 1280, 1280, 3, 1, 1), (3, 5, 7, 160, 200, 3, 1, 1)):
        _conv_int8_case(*shape, gen, False)
    for r, c, n in ((120, 1280, 1280), (2 * 77, 1024, 640), (2, 1280, 320), (100, 64, 8)):
        _dense_int8_case(r, c, n, gen, False)
    _sync()
    return rows


def _quantize_case(shape, gen, timed):
    import torch

    from d3roma_tpu_torch.ops.kernels import quantize_int8_plain, quantize_int8_scalar
    from d3roma_tpu_torch.ops.quant import fp32

    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    scale = fp32(x.float().abs().max().item() * 0.9 / 127)  # some values clip
    out = quantize_int8_scalar(x, scale)
    ref = quantize_int8_plain(x, scale)
    _sync()
    err = (out.int() - ref.int()).abs().max().item()
    row = {"shape": list(shape), "max_abs_err": float(err), "tol": 0.0}
    if timed:
        n = x.numel()
        row["bound_ms"], row["bound_by"] = bound(0.0, 3.0 * n)
        row["plain_ms"] = time_ms(lambda: quantize_int8_plain(x, scale))
        # the library call is a yardstick only where it gives the kernel's
        # int8 values (half to even after an IEEE division, clipped to +-127)
        xf = x.float()

        def library():
            return torch.quantize_per_tensor(xf, scale, 0, torch.qint8)

        lib_q = library().int_repr()
        _sync()
        row["library_mismatches"] = int((lib_q != out).sum().item())
        row["library_max_diff"] = int((lib_q.int() - out.int()).abs().max().item())
        if row["library_mismatches"] == 0:
            _timed_against_library(row, lambda: quantize_int8_scalar(x, scale), library,
                                   split=True)
            row["library_call"] = "torch.quantize_per_tensor(x.float(), s, 0, torch.qint8)"
        else:
            row["ms"] = time_ms(lambda: quantize_int8_scalar(x, scale))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["host_ms"], row["device_ms"], row["device_ms_by_launch"] = host_and_device_ms(
                lambda: quantize_int8_scalar(x, scale))
            row["library_ms"] = None
            row["library_call"] = None
    return _check_row("quantize_int8", row, float(err), 0.0)


def _back_to_back(name, shape, consumer, expected, inputs):
    """consumer(x) for the three inputs back to back, with no synchronize
    between them, each call quantizing its x into the one reused int8
    workspace; the second and third results against `expected` (theirs),
    bit-equal. A consumer kernel that read the workspace before its own
    quantize had finished would see the call before's values (the first
    call's are there for the second)."""
    consumer(inputs[0])
    outs = [consumer(x) for x in inputs[1:]]
    _sync()
    errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(outs, expected)]
    row = {"shape": list(shape), "max_abs_err": max(errs),
           "inputs_differ": bool((expected[0] != expected[1]).any().item())}
    print(f"  back to back {name} {row}", flush=True)
    if max(errs) != 0.0 or not row["inputs_differ"]:
        raise AssertionError(f"back to back {name} {list(shape)}: {row}")
    return row


def pdl_race_cases(gen):
    """Each int8 op whose C entry point quantizes its input and launches its
    first kernel as a dependent launch on that quantize, back to back on
    three distinct inputs through the one reused workspace (_back_to_back):
    the int8 conv in each epilogue, split and not, two dense layers and the
    int8 GEGLU (split and not) against their plain versions; the fused int8
    self-attention, which differs from its plain version by one bf16
    rounding, against its own results of the same inputs taken one at a
    time after a synchronize (those within REL_TOL of the plain version)."""
    import torch

    from d3roma_tpu_torch.ops.kernels import (
        conv2d_int8,
        conv2d_int8_plain,
        fused_self_attention_int8,
        fused_self_attention_int8_plain,
        geglu_ff_int8,
        geglu_ff_int8_plain,
    )
    from d3roma_tpu_torch.ops.quant import fp32, quantize_weight

    def inputs(shape):
        xs = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(3)]
        return xs, fp32(xs[1].float().abs().max().item() * 1.25 / 127)

    rows = []
    for b, h, w, cin, cout, k, stride, pad, epi in (
            (BATCH, 23, 40, 1920, 640, 3, 1, 1, "xla"),   # K split 2
            (BATCH, 45, 80, 320, 320, 3, 2, 1, "xla"),    # stride 2, K split 4
            (BATCH, 45, 80, 320, 320, 3, 1, 1, "tpu"),
            (BATCH, 23, 40, 640, 640, 3, 1, 1, "halo"),
            (1, 1, 7200, 320, 320, 1, 1, 0, "xla"),       # the dense layers: one row of pixels
            (1, 1, 480, 1280, 1280, 1, 1, 0, "xla")):
        xs, act = inputs((b, h, w, cin))
        wq, ws = quantize_weight((torch.randn((cout, k, k, cin), generator=gen, device="cuda")
                                  * (k * k * cin) ** -0.5).to(torch.bfloat16))
        bias = (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        rows.append(_back_to_back(
            f"conv2d_int8 ({epi})", (b, h, w, cin, cout, k, stride, pad),
            lambda x: conv2d_int8(x, wq, ws, act, bias, stride, pad, epi),
            [conv2d_int8_plain(x, wq, ws, act, bias, stride, pad, epi) for x in xs[1:]], xs))
    for rows_, c, f in ((BATCH * 3600, 320, 1280), (BATCH * 60, 1280, 5120)):
        xs, act = inputs((1, rows_, c))
        ops_in = _int8_ff_operands(c, f, gen)
        rows.append(_back_to_back("geglu_ff_int8", (rows_, c, f),
                                  lambda x: geglu_ff_int8(x, *ops_in, act),
                                  [geglu_ff_int8_plain(x, *ops_in, act) for x in xs[1:]], xs))
    for n, c in ((920, 640), (3600, 320)):
        xs, act = inputs((BATCH, n, c))
        ops_in, _ = _fused_attention_operands(c, gen)
        heads = c // 64
        alone = []
        for x in xs[1:]:
            alone.append(fused_self_attention_int8(x, *ops_in, heads, act))
            _sync()
        rows.append(_back_to_back("fused_self_attention_int8", (BATCH, n, c),
                                  lambda x: fused_self_attention_int8(x, *ops_in, heads, act),
                                  alone, xs))
        ref = fused_self_attention_int8_plain(xs[2], *ops_in, heads, act).float()
        err = (alone[1].float() - ref).abs().max().item()
        _check_row("fused_self_attention_int8 (alone, against plain)",
                   {"shape": [BATCH, n, c], "max_abs_err": err}, err,
                   REL_TOL * ref.abs().max().item())
    _sync()
    return rows


def _dynamic_operands(b, h, w, cin, cout, k, gen, zero_item=False, spread=True):
    """x [b, h, w, cin] bf16 whose batch items (rows, for a dense: h = 1) have
    different absmax (item i scaled by 1 + i, with `spread`; one item all
    zeros with zero_item), a weight quantized as the port quantizes it, and a
    bias."""
    import torch

    from d3roma_tpu_torch.ops.quant import quantize_weight

    x = torch.randn((b, h, w, cin), generator=gen, device="cuda")
    if spread:
        x = x * torch.arange(1, b + 1, device="cuda").view(b, 1, 1, 1)
    if zero_item:
        x[-1] = 0.0
    wt = (torch.randn((cout, k, k, cin), generator=gen, device="cuda")
          * (k * k * cin) ** -0.5).to(torch.bfloat16)
    bias = (torch.randn((cout,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return x.to(torch.bfloat16), wt, *quantize_weight(wt), bias


def _dynamic_plan_fields(b, h, w, cin, cout, k, stride, padding, per_row, route=None):
    """The plan of one launch (dynamic_plan's, or route_plan's on `route`)
    and its fields for a row."""
    import torch

    from d3roma_tpu_torch.ops.kernels import _build, conv2d

    if route is None:
        plan, _, _ = conv2d.dynamic_launch_ints(b, h, w, cin, cout, k, k, stride, padding,
                                                per_row, torch.device("cuda", 0))
    else:
        plan = conv2d.route_plan(route, b, h, w, cin, cout, k, k, stride, padding,
                                 _build.sm_count(0))
    fields = {"route": plan.route, "chunks": plan.chunks, "team": plan.team,
              "smem_bytes": plan.smem_bytes, "planned_ops": plan.device_ops}
    if plan.conv is not None:
        fields.update(box=list(plan.conv.box), bn=plan.conv.bn, splits=plan.conv.splits)
    return plan, fields


def _check_dynamic_ops(name, row, plan, fn, sessions: int = 3):
    """The device ops of one call: each of a dynamic call's launches is a
    kernel of its own, so the distinct device activities of calls of fn
    (torch.profiler, the union over `sessions` sessions of two calls: a busy
    session can drop an event, never add one) must be the plan's count,
    with no memset; a dense at most 2 (3 with a split), 1 on the small
    route; a loader convolution at most 2 plus a split sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    names = set()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            _sync()
        names |= {evt.key for evt in prof.key_averages()
                  if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA}
    row["device_ops"] = len(names)
    split = plan.conv is not None and plan.conv.splits > 1
    limit = {"small": 1, "rows": 2, "loader": 2, "separate": 3}[plan.route] + split
    memsets = [n for n in names if "memset" in n.lower()]
    if len(names) != plan.device_ops or len(names) > limit or memsets:
        raise AssertionError(f"{name} {row['shape']}: {len(names)} device ops a call (plan "
                             f"{plan.device_ops}, at most {limit}), memsets {memsets}: "
                             f"{sorted(names)}")


def _dynamic_case(b, h, w, cin, cout, k, stride, padding, gen, timed, zero_item=False,
                  route=None):
    """The dynamic int8 conv kernels (per-batch-item scales computed on the
    device, "xla" order) on the plan's route (or `route`) against their
    plain version: bit-equal, with the device ops of a call checked."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_int8_dynamic, conv2d_int8_dynamic_plain
    from d3roma_tpu_torch.ops.kernels.conv2d import _dynamic_on_route, conv_out_hw

    x, wt, wq, ws, bias = _dynamic_operands(b, h, w, cin, cout, k, gen, zero_item)
    if route is None:
        kernel = lambda: conv2d_int8_dynamic(x, wq, ws, bias, stride, padding)  # noqa: E731
    else:
        kernel = lambda: _dynamic_on_route(route, x, wq, ws, bias, stride, padding)  # noqa: E731
    out = kernel()
    ref = conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, padding).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    plan, fields = _dynamic_plan_fields(b, h, w, cin, cout, k, stride, padding, False, route)
    row = {"shape": [b, h, w, cin, cout, k, stride, padding], "zero_item": zero_item,
           "max_abs_err": err, "tol": 0.0, "max_abs_out": ref.abs().max().item(), **fields}
    _check_dynamic_ops("conv2d_int8_dynamic", row, plan, kernel)
    if timed:
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        wc = wt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        oh, ow = conv_out_hw(h, w, k, stride, padding)
        ops = 2.0 * b * oh * ow * cout * k * k * cin
        nbytes = 2.0 * b * h * w * cin + 1.0 * cout * k * k * cin + 6.0 * cout + 2.0 * b * oh * ow * cout
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        _timed_against_library(row, kernel, lambda: F.conv2d(xc, wc, bias, stride, padding),
                               split=True)
        row["plain_ms"] = time_ms(
            lambda: conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, padding), reps=3,
            warmup=1)
        row["library_call"] = "F.conv2d (bf16, cuDNN, channels_last)"
    return _check_row("conv2d_int8_dynamic", row, err, 0.0)


def _int_mm_dense(x2, wq, ws, bias):
    """The dynamic dense as PyTorch calls: per-row scales, quantize,
    torch._int_mm (cuBLASLt int8), then the dequantization and the bias."""
    import torch

    from d3roma_tpu_torch.ops.kernels.quantize import INV127

    s = torch.clamp_min(x2.float().abs().amax(dim=1, keepdim=True) * INV127, 1e-8)
    xq = torch.clamp(torch.round(x2.float() / s), -127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq.t()).float() * s * ws).to(torch.bfloat16) + bias


def _dynamic_dense_case(rows, c, n, gen, timed, zero_item=False):
    """A dynamic int8 dense (ops/quant.py::int8_linear_dynamic: the dynamic
    kernels over the rows, one scale a row) against the plain version:
    bit-equal, with the device ops of a call checked. Its library call is
    one bf16 F.linear, as the static dense rows have it; where cuBLASLt
    takes the shape, the int8 composite (torch._int_mm with the per-row
    scaling around it, four calls) is timed beside it as a note."""
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_int8_dynamic_plain
    from d3roma_tpu_torch.ops.quant import int8_linear_dynamic

    x4, wt, wq, ws, bias = _dynamic_operands(rows, 1, 1, c, n, 1, gen, zero_item)
    x = x4.view(rows, c)
    wq, ws = wq.view(n, c), ws
    kernel = lambda: int8_linear_dynamic(x, wq, ws, bias)  # noqa: E731
    out = kernel()
    ref = conv2d_int8_dynamic_plain(x.view(1, 1, rows, c), wq.view(n, 1, 1, c), ws, bias, 1, 0,
                                    per_row=True).view(rows, n).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    plan, fields = _dynamic_plan_fields(1, 1, rows, c, n, 1, 1, 0, True)
    row = {"shape": [rows, c, n], "site": "dense", "zero_item": zero_item, "max_abs_err": err,
           "tol": 0.0, "max_abs_out": ref.abs().max().item(), **fields}
    _check_dynamic_ops("conv2d_int8_dynamic (dense)", row, plan, kernel)
    if timed:
        ops = 2.0 * rows * c * n
        nbytes = 2.0 * rows * c + 1.0 * n * c + 6.0 * n + 2.0 * rows * n
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        w2 = wt.view(n, c)
        _timed_against_library(row, kernel, lambda: F.linear(x, w2, bias), split=True)
        row["library_call"] = "F.linear (bf16, cuBLAS)"
        try:
            lib = _int_mm_dense(x, wq, ws, bias)
            _sync()
            row["composite_max_diff"] = (lib.float() - ref).abs().max().item()
            row["composite_ms"] = time_ms(lambda: _int_mm_dense(x, wq, ws, bias))
        except RuntimeError as e:  # cuBLASLt's shape limits (16 rows or fewer)
            row["composite_refused"] = str(e)[:120]
        row["plain_ms"] = time_ms(lambda: conv2d_int8_dynamic_plain(
            x.view(1, 1, rows, c), wq.view(n, 1, 1, c), ws, bias, 1, 0, per_row=True), reps=3,
            warmup=1)
    return _check_row("conv2d_int8_dynamic (dense)", row, err, 0.0)


# The "all" path's dynamic conv sites at batch 2 (timed): the UNet's 3x3
# (down block 0, up block 2), stride-2 downsampler and 1x1 shortcut, the VAE
# encoder's 3x3 and stride-2 downsampler (both conditions: batch 4), the
# VAE's 1x1 shortcut
DYNAMIC_CONV_SHAPES = ((BATCH, 45, 80, 320, 320, 3, 1, 1), (BATCH, 23, 40, 1920, 640, 3, 1, 1),
                       (BATCH, 45, 80, 320, 320, 3, 2, 1), (BATCH, 45, 80, 640, 320, 1, 1, 0),
                       (2 * BATCH, H, W, 128, 128, 3, 1, 1),
                       (2 * BATCH, H + 1, W + 1, 128, 128, 3, 2, 0),
                       (BATCH, H, W, 256, 128, 1, 1, 0))
# The transformers' dense layers at batch 2 (timed) and the cross-attention's
# key and value projections of the 2-token context (4 rows); then batch 16:
# at each UNet level (3600, 920, 240, 60 tokens at 320, 640, 1280, 1280
# channels) the attention projections (C -> C), the unfused feed-forward's
# two denses (C -> 8C, 4C -> C) and the key and value projections (32 rows,
# 1024 -> C), as chip_smoke's "all" routing dry pass logs them
DYNAMIC_DENSE_SHAPES = ((7200, 320, 320), (1840, 640, 640), (480, 1280, 1280),
                        (2 * BATCH, 1024, 320))
DYNAMIC_DENSE_SHAPES_B16 = tuple(
    shape for t, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280))
    for shape in ((16 * t, c, c), (16 * t, c, 8 * c), (16 * t, 4 * c, c))) + tuple(
        (32, 1024, c) for c in (320, 640, 1280))


def _dynamic_many_items_case(b, h, w, cin, cout, k, stride, padding, gen):
    """A dynamic convolution of more batch items than one launch's table of
    scales holds (MAX_GROUPS): the call launches its chunks
    (dynamic_chunks) and must be bit-equal to the plain version over the
    whole batch, one call counted."""
    from d3roma_tpu_torch.ops.kernels import conv2d_int8_dynamic, conv2d_int8_dynamic_plain
    from d3roma_tpu_torch.ops.kernels.conv2d import dynamic_chunks, dynamic_plan

    x, _, wq, ws, bias = _dynamic_operands(b, h, w, cin, cout, k, gen, zero_item=True)
    before = conv2d_int8_dynamic.launches
    out = conv2d_int8_dynamic(x, wq, ws, bias, stride, padding)
    calls = conv2d_int8_dynamic.launches - before
    ref = conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, padding).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    chunks = dynamic_chunks(b, False)
    row = {"shape": [b, h, w, cin, cout, k, stride, padding], "zero_item": True,
           "max_abs_err": err, "tol": 0.0, "chunks": [j - i for i, j in chunks],
           "routes": [dynamic_plan(j - i, h, w, cin, cout, k, k, stride, padding, False).route
                      for i, j in chunks], "calls_counted": calls}
    if len(chunks) < 2 or calls != 1:
        raise AssertionError(f"many items: {row}")
    return _check_row("conv2d_int8_dynamic (chunks of items)", row, err, 0.0)


def dynamic_int8_cases(gen):
    """The dynamic int8 kernels at the "all" path's conv and dense shapes
    (batch 2; timed) and at the batch-16 dense shapes (checked only;
    scripts/time_dynamic.py times them), each route's ragged shapes and
    all-zero items (checked only), the 1x1 and stride-2 sites on both
    convolution routes, a convolution of more batch items than one launch
    takes, and each route back to back on three inputs of different absmax
    through the reused workspace (the kernels read the scales the call
    before them wrote: a stale or early read shows)."""
    import torch

    from d3roma_tpu_torch.ops.kernels import conv2d_int8_dynamic, conv2d_int8_dynamic_plain
    from d3roma_tpu_torch.ops.quant import int8_linear_dynamic

    rows = [_dynamic_case(*shape, gen, True) for shape in DYNAMIC_CONV_SHAPES]
    rows += [_dynamic_dense_case(*shape, gen, True) for shape in DYNAMIC_DENSE_SHAPES]
    b16 = [_dynamic_dense_case(*shape, gen, False) for shape in DYNAMIC_DENSE_SHAPES_B16]
    for shape in DYNAMIC_CONV_SHAPES:  # the other route of the 1x1 and stride-2 sites
        if shape[5] == 1 or shape[6] == 2:
            for route in ("loader", "separate"):
                _dynamic_case(*shape, gen, False, route=route)
    for shape in ((1, 7, 9, 32, 64, 3, 1, 1), (3, 5, 6, 64, 96, 3, 2, 1),
                  (2, 9, 11, 32, 130, 1, 1, 0), (5, 13, 17, 96, 34, 3, 2, 0),
                  (3, 6, 10, 1280, 1280, 3, 1, 1), (2, 9, 11, 96, 66, 1, 1, 0)):
        for route in (None, "loader", "separate"):
            _dynamic_case(*shape, gen, False, route=route)
    for route in ("loader", "separate"):
        _dynamic_case(3, 12, 20, 64, 64, 3, 2, 1, gen, False, zero_item=True, route=route)
        _dynamic_case(3, 12, 20, 64, 64, 1, 1, 0, gen, False, zero_item=True, route=route)
    _dynamic_case(3, 12, 20, 64, 64, 3, 1, 1, gen, False, zero_item=True)
    for r, c, n in ((100, 64, 8), (5, 96, 40), (64, 2048, 64), (65, 1024, 320),
                    (300, 5120, 1280), (7, 320, 1280)):
        _dynamic_dense_case(r, c, n, gen, False, zero_item=True)
    _dynamic_dense_case(3, 96, 40, gen, False)
    for shape in ((130, 6, 10, 64, 64, 3, 2, 1), (130, 6, 10, 64, 64, 1, 1, 0),
                  (300, 5, 7, 32, 64, 3, 1, 1)):
        rows.append(_dynamic_many_items_case(*shape, gen))

    b2b = []
    for b, h, w, cin, cout, k, stride, pad in ((BATCH, 23, 40, 1920, 640, 3, 1, 1),  # separate, split
                                               (2 * BATCH, 90, 160, 256, 256, 3, 2, 1),
                                               (BATCH, 45, 80, 320, 320, 3, 2, 1),
                                               (BATCH, 90, 160, 256, 128, 1, 1, 0),  # loader
                                               (BATCH, 45, 80, 640, 320, 1, 1, 0),
                                               (1, 1, 7200, 320, 320, 1, 1, 0),     # rows
                                               (1, 1, 960, 5120, 1280, 1, 1, 0),
                                               (1, 1, 2 * BATCH, 1024, 320, 1, 1, 0),  # small
                                               (1, 1, 32, 1024, 1280, 1, 1, 0)):
        per_row = b == 1
        xs = [_dynamic_operands(b, h, w, cin, cout, k, gen)[0] * f for f in (1.0, 3.0, 0.5)]
        _, _, wq, ws, bias = _dynamic_operands(1, 1, 1, cin, cout, k, gen)
        plan, _ = _dynamic_plan_fields(b, h, w, cin, cout, k, stride, pad, per_row)
        if per_row:
            consumer = lambda x: int8_linear_dynamic(x.view(w, cin), wq.view(cout, cin), ws,  # noqa: E731
                                                     bias)
            expected = [conv2d_int8_dynamic_plain(x, wq, ws, bias, 1, 0, per_row=True)
                        .view(w, cout) for x in xs[1:]]
        else:
            consumer = lambda x: conv2d_int8_dynamic(x, wq, ws, bias, stride, pad)  # noqa: E731
            expected = [conv2d_int8_dynamic_plain(x, wq, ws, bias, stride, pad) for x in xs[1:]]
        row = _back_to_back(f"conv2d_int8_dynamic ({plan.route})",
                            (b, h, w, cin, cout, k, stride, pad), consumer, expected, xs)
        b2b.append(dict(row, route=plan.route))
    routes = {r["route"] for r in b2b}
    if routes != {"small", "rows", "loader", "separate"}:
        raise AssertionError(f"back to back: routes {routes}, want all four")
    _sync()
    return rows, b2b, b16


def attention_int8_cases(gen):
    """The int8 whole-row attention at the bench-default path's shapes
    (timed) and ragged ones (checked only): every head width, N and M off
    the 128-row and 128-key tiles."""
    rows = [_attention_int8_case(BATCH, 3600, 3600, 5, 64, gen, True),
            _attention_int8_case(BATCH, 920, 920, 10, 64, gen, True),
            _attention_int8_case(2 * BATCH, 3600, 3600, 1, 512, gen, True),  # VAE encode
            _attention_int8_case(BATCH, 3600, 3600, 1, 512, gen, True)]      # VAE decode
    for shape in ((1, 600, 600, 2, 64), (2, 300, 77, 3, 64), (1, 100, 130, 2, 128),
                  (1, 70, 50, 1, 32), (1, 200, 150, 1, 512), (1, 90, 90, 2, 256),
                  (1, 300, 1000, 2, 96), (2, 1000, 300, 1, 64), (1, 129, 1, 1, 128),
                  (1, 129, 1, 1, 512), (2, 65, 200, 1, 256), (1, 64, 129, 2, 512)):
        _attention_int8_case(*shape, gen, False)
    return rows


def int8_kernel_phase():
    """The int8 kernels against their plain versions at the bench-default
    path's shapes (timed) and ragged ones (checked only)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = {"quantize": [_quantize_case((BATCH, 3600, 320), gen, True)]}
    for shape in ((7,), (3, 5, 33)):
        _quantize_case(shape, gen, False)
    rows["attention_int8"] = attention_int8_cases(gen)
    rows["geglu_int8"] = geglu_int8_cases(gen)
    rows["conv2d_int8"] = conv_int8_cases(gen)
    rows["back_to_back"] = pdl_race_cases(gen)
    (rows["conv2d_int8_dynamic"], rows["back_to_back_dynamic"],
     rows["conv2d_int8_dynamic_b16"]) = dynamic_int8_cases(gen)
    return rows


def _gn_case(shape, gen, timed, dtype="bfloat16", groups=32, param_dtype="bfloat16",
             count_ops=True):
    """The fused GroupNorm against its plain version (gamma and beta in
    `param_dtype`, as the models hold them): one device op a call (counted
    by the profiler unless `count_ops` is false), the output bit-identical
    across two calls, within REL_TOL of the plain version."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import group_norm_silu, group_norm_silu_plain
    from d3roma_tpu_torch.ops.kernels import groupnorm as kgn

    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(getattr(torch, dtype))
    gamma = (1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")).to(
        getattr(torch, param_dtype))
    beta = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(getattr(torch, param_dtype))
    out = group_norm_silu(x, gamma, beta, groups, 1e-5)
    again = group_norm_silu(x, gamma, beta, groups, 1e-5)
    ref = group_norm_silu_plain(x, gamma, beta, groups, 1e-5).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    plan = kgn.gn_plan(shape[0], shape[1] * shape[2], c, groups, x.element_size(),
                       torch.cuda.get_device_properties(0).multi_processor_count)
    row = {"shape": list(shape), "dtype": dtype, "groups": groups, "max_abs_err": err,
           "tol": tol, "max_abs_out": ref.abs().max().item(),
           "repeats_bitwise": bool(torch.equal(out, again)),
           "device_ops_per_call": device_ops_per_call(
               lambda: group_norm_silu(x, gamma, beta, groups, 1e-5)) if count_ops else None,
           "plan": {"k": plan.k, "band": plan.band, "cluster": plan.cluster, "per": plan.per,
                    "resident": plan.resident, "smem_bytes": plan.smem_bytes,
                    "ctas": plan.ctas}}
    if not row["repeats_bitwise"] or (count_ops and row["device_ops_per_call"] != 1):
        raise AssertionError(f"group_norm_silu {list(shape)}: {row}")
    if timed:
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        gb, bb = gamma.to(x.dtype), beta.to(x.dtype)
        row["bound_ms"], row["bound_by"] = bound(0.0, 2.0 * x.numel() * x.element_size()
                                                 + 2.0 * c * gamma.element_size())
        _timed_against_library(row, lambda: group_norm_silu(x, gamma, beta, groups, 1e-5),
                               lambda: F.silu(F.group_norm(xc, groups, gb, bb, 1e-5)),
                               split=True)
        row["plain_ms"] = time_ms(lambda: group_norm_silu_plain(x, gamma, beta, groups, 1e-5))
        row["library_call"] = "F.silu(F.group_norm(x)) (bf16, channels_last)"
    return _check_row("group_norm_silu", row, err, tol)


# the opt-in path's fused GroupNorm sites (its routing dry pass), timed
GN_SHAPES = ((BATCH, 45, 80, 320), (BATCH, 23, 40, 1920), (BATCH, 12, 20, 1280),
             (2 * BATCH, 45, 80, 512))


def groupnorm_cases(gen):
    """The fused GroupNorm at the opt-in path's shapes (timed), at every other
    site the routing dry pass admits, at the gate's 4 MiB edge (bf16 and
    fp32; in one group, where no cluster holds a band: the second read of x
    from L2), with a cluster of 16 (one group, 2 MiB), and ragged ones."""
    rows = [_gn_case(s, gen, True) for s in GN_SHAPES]
    for shape in ((BATCH, 12, 20, 640), (BATCH, 12, 20, 1920), (BATCH, 12, 20, 2560),
                  (BATCH, 23, 40, 320), (BATCH, 23, 40, 640), (BATCH, 23, 40, 960),
                  (BATCH, 23, 40, 1280), (BATCH, 45, 80, 512), (BATCH, 6, 10, 1280),
                  (BATCH, 6, 10, 2560)):
        _gn_case(shape, gen, False)
    for shape, dtype, groups, pdt in (((1, 64, 64, 512), "bfloat16", 32, "bfloat16"),
                                      ((1, 64, 64, 256), "float32", 32, "float32"),
                                      ((1, 64, 64, 512), "bfloat16", 1, "float32"),
                                      ((1, 32, 64, 512), "bfloat16", 1, "bfloat16"),
                                      ((1, 5, 7, 64), "float32", 32, "float32"),
                                      ((1, 3, 3, 2560), "bfloat16", 32, "bfloat16"),
                                      ((2, 9, 11, 96), "bfloat16", 32, "float32"),
                                      ((1, 6, 10, 2560), "float32", 32, "bfloat16"),
                                      ((3, 7, 5, 200), "bfloat16", 8, "bfloat16")):
        _gn_case(shape, gen, False, dtype, groups, pdt)
    _sync()
    return rows


def _wino_case(b, h, w, c, o, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import (
        conv3x3_winograd,
        conv3x3_winograd_plain,
        winograd_weight,
    )

    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((o, c, 3, 3), generator=gen, device="cuda")
          * (9 * c) ** -0.5).to(torch.bfloat16)
    bias = (torch.randn((o,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    u = winograd_weight(wt)
    out = conv3x3_winograd(x, u, torch.bfloat16, bias)
    ref = conv3x3_winograd_plain(x, u, torch.bfloat16, bias).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, h, w, c, o], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item()}
    if timed:
        xc = x.permute(0, 3, 1, 2)
        wc = wt.contiguous(memory_format=torch.channels_last)
        th, tw = (h + 1) // 2, (w + 1) // 2
        ops = 2.0 * 16 * b * th * tw * c * o
        nbytes = 2.0 * (b * h * w * c + 16 * o * c + o + b * h * w * o)
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes)
        _timed_against_library(row, lambda: conv3x3_winograd(x, u, torch.bfloat16, bias),
                               lambda: F.conv2d(xc, wc, bias, 1, 1), split=True)
        row["plain_ms"] = time_ms(lambda: conv3x3_winograd_plain(x, u, torch.bfloat16, bias),
                                  reps=3, warmup=1)
        row["library_call"] = "F.conv2d (bf16, cuDNN, channels_last)"
    return _check_row("winograd", row, err, tol)


def _fused_attention_operands(c, gen):
    import torch

    from d3roma_tpu_torch.ops.quant import quantize_weight

    ws = [(torch.randn((c, c), generator=gen, device="cuda") * c ** -0.5).to(torch.bfloat16)
          for _ in range(4)]
    qs = [quantize_weight(w) for w in ws[:3]]
    bo = torch.randn((c,), generator=gen, device="cuda") * 0.1
    return (torch.cat([q for q, _ in qs]).contiguous(), torch.cat([s for _, s in qs]).contiguous(),
            ws[3], bo), ws


def _attention_fused_case(b, n, c, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import (
        fused_self_attention_int8,
        fused_self_attention_int8_plain,
    )
    from d3roma_tpu_torch.ops.quant import fp32

    heads = c // 64
    x = torch.randn((b, n, c), generator=gen, device="cuda").to(torch.bfloat16)
    ops_in, ws = _fused_attention_operands(c, gen)
    act = fp32(x.float().abs().max().item() * 1.25 / 127)
    out = fused_self_attention_int8(x, *ops_in, heads, act)
    ref = fused_self_attention_int8_plain(x, *ops_in, heads, act).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, n, c, heads], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item()}
    if timed:
        bo16 = ops_in[3].to(torch.bfloat16)

        def library():
            q, k, v = (F.linear(x, w).view(b, n, heads, 64).transpose(1, 2) for w in ws[:3])
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
            return F.linear(o, ws[3], bo16)

        # int8: the QKV projection and both attention products; bf16: the
        # output projection (its operations counted at the int8 peak's
        # equivalent: twice the bf16 time's worth)
        ops = b * (6.0 * n * c * c + 4.0 * n * n * c) + b * 2.0 * n * c * c * (
            H100_INT8_OPS / H100_BF16_FLOPS)
        nbytes = 2.0 * 2 * b * n * c + 3.0 * c * c + 2.0 * c * c + 4.0 * 4 * c
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS,
                                                 exps=float(b * heads * n * n))
        _timed_against_library(row, lambda: fused_self_attention_int8(x, *ops_in, heads, act),
                               library, split=True)
        row["plain_ms"] = time_ms(
            lambda: fused_self_attention_int8_plain(x, *ops_in, heads, act), reps=3, warmup=1)
        row["library_call"] = "4 F.linear + F.scaled_dot_product_attention (bf16)"
    return _check_row("attention_fused_int8", row, err, tol)


def opt_in_kernel_phase():
    """The opt-in configuration's kernels against their plain versions at
    its shapes (timed) and ragged ones (checked only)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5678)
    rows = {"groupnorm_silu": groupnorm_cases(gen)}
    rows["winograd"] = winograd_cases(gen)
    rows["attention_fused_int8"] = attention_fused_int8_cases(gen)
    _sync()
    return rows


def winograd_cases(gen):
    """The Winograd conv at the opt-in path's shapes (timed) and ragged ones
    (checked only)."""
    rows = [_wino_case(*s, gen, True) for s in (
        (BATCH, 45, 80, 320, 320), (BATCH, 45, 80, 640, 320), (BATCH, 23, 40, 640, 640),
        (2 * BATCH, 45, 80, 512, 512), (2 * BATCH, 180, 320, 128, 256))]
    # ragged: odd H and W with the taps split (the small ones) and not
    # (4, 45, 81, 96, 136: 90 tiles), channel tiles past O
    for shape in ((1, 7, 9, 32, 40), (1, 5, 3, 64, 8), (2, 13, 20, 96, 136), (1, 1, 1, 32, 32),
                  (4, 45, 81, 96, 136)):
        _wino_case(*shape, gen, False)
    return rows


def attention_fused_int8_cases(gen):
    """The fused int8 self-attention at the opt-in path's four levels (timed)
    and ragged ones (checked only)."""
    rows = [_attention_fused_case(BATCH, n, c, gen, True) for n, c in (
        (3600, 320), (920, 640), (240, 1280), (60, 1280))]
    for n, c in ((300, 128), (65, 64), (1000, 320), (257, 192)):
        _attention_fused_case(1, n, c, gen, False)
    return rows


def _attention_fused_bf16_case(b, n, c, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import (
        fused_self_attention_bf16,
        fused_self_attention_bf16_plain,
    )

    heads = c // 64
    x = torch.randn((b, n, c), generator=gen, device="cuda").to(torch.bfloat16)
    ws = [(torch.randn((c, c), generator=gen, device="cuda") * c ** -0.5).to(torch.bfloat16)
          for _ in range(4)]
    bo = torch.randn((c,), generator=gen, device="cuda") * 0.1
    wqkv = torch.cat(ws[:3]).contiguous()
    out = fused_self_attention_bf16(x, wqkv, ws[3], bo, heads)
    ref = fused_self_attention_bf16_plain(x, wqkv, ws[3], bo, heads).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, n, c, heads], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item(),
           "qkv_plan": _conv_plan_fields(1, 1, b * n, c, 3 * c, 1, 1, 0, 2, "bf16")}
    if timed:
        bo16 = bo.to(torch.bfloat16)

        def library():
            q, k, v = (F.linear(x, w).view(b, n, heads, 64).transpose(1, 2) for w in ws[:3])
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
            return F.linear(o, ws[3], bo16)

        flops = b * (8.0 * n * c * c + 4.0 * n * n * c)
        nbytes = 2.0 * 2 * b * n * c + 2.0 * 4 * c * c + 4.0 * c
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, exps=float(b * heads * n * n))
        _timed_against_library(row, lambda: fused_self_attention_bf16(x, wqkv, ws[3], bo, heads),
                               library, split=True)
        row["plain_ms"] = time_ms(
            lambda: fused_self_attention_bf16_plain(x, wqkv, ws[3], bo, heads), reps=5)
        row["library_call"] = "4 F.linear + F.scaled_dot_product_attention (bf16)"
    return _check_row("attention_fused_bf16", row, err, tol)


def attention_fused_bf16_cases(gen):
    """The bf16 fused self-attention at the latency-fused path's shape
    (timed) and ragged ones (checked only)."""
    rows = [_attention_fused_bf16_case(BATCH, 920, 640, gen, True)]
    for b, n, c in ((1, 1000, 128), (1, 65, 64), (2, 300, 192), (2, 3600, 320)):
        _attention_fused_bf16_case(b, n, c, gen, False)
    return rows


def _conv_bf16_case(b, h, w, cin, cout, gen, timed, halo=False):
    """conv3x3_flat(quant=None), or conv3x3_halo(quant=None) with `halo`,
    against the bf16 conv's plain version."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_bf16, conv2d_bf16_plain, conv3x3_flat
    from d3roma_tpu_torch.ops.kernels import conv3x3_halo

    x = torch.randn((b, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          * (9 * cin) ** -0.5).to(torch.bfloat16)  # HWIO
    wk = wt.permute(3, 0, 1, 2).contiguous()
    out = conv3x3_halo(x, wt, None) if halo else conv3x3_flat(x, wt)
    ref = conv2d_bf16_plain(x, wk, 1, 1, torch.float32)
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, h, w, cin, cout], "entry": "conv3x3_halo" if halo else "conv3x3_flat",
           "max_abs_err": err, "tol": tol, "max_abs_out": ref.abs().max().item(),
           **_conv_plan_fields(b, h, w, cin, cout, 3, 1, 1, 2, "bf16")}
    if timed:
        xc = x.permute(0, 3, 1, 2)
        wc = wk.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        flops = 2.0 * b * h * w * cout * 9 * cin
        nbytes = 2.0 * (b * h * w * cin + 9 * cin * cout + b * h * w * cout)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
        _timed_against_library(row, lambda: conv2d_bf16(x, wk, 1, 1),
                               lambda: F.conv2d(xc, wc, None, 1, 1))
        row["plain_ms"] = time_ms(lambda: conv2d_bf16_plain(x, wk, 1, 1), reps=5)
        row["library_call"] = "F.conv2d (bf16, cuDNN, channels_last)"
    return _check_row("conv2d_bf16", row, err, tol)


def _conv_epilogue_case(name, epilogue, b, h, w, cin, cout, gen, timed, saturate=False):
    """One of the JAX 3x3 int8 entry points (conv3x3_flat, conv3x3_rowtap,
    conv3x3_halo), served by the int8 conv kernel in its epilogue, against
    the kernel's plain version: bit-equal (tolerance 0). `saturate` feeds
    values near the int8 limits at Cin >= 512, where a row of taps' int32
    partial passes 2^24 and the "halo" and "tpu" orders differ."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import conv2d_int8, conv2d_int8_plain
    from d3roma_tpu_torch.ops.kernels import conv2d as kconv
    from d3roma_tpu_torch.ops.quant import fp32, quantize_weight

    x = torch.randn((b, h, w, cin), generator=gen, device="cuda")
    wt = torch.randn((3, 3, cin, cout), generator=gen, device="cuda") * (9 * cin) ** -0.5
    if saturate:
        x, wt = 4.0 + 0.2 * x, (9 * cin) ** -0.5 * (1.0 + 0.05 * wt)
    x, wt = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    act = fp32(x.float().abs().max().item() / 127)
    # fp32 outputs where the orders must be told apart: a bf16 rounding of
    # the output would hide a difference of a few fp32 ulps
    odt = torch.float32 if saturate else torch.bfloat16
    entry = {"conv3x3_flat": lambda: kconv.conv3x3_flat(x, wt, "static", act, odt),
             "conv3x3_rowtap": lambda: kconv.conv3x3_rowtap(x, wt, act, odt),
             "conv3x3_halo": lambda: kconv.conv3x3_halo(x, wt, "static", act, odt)}[name]
    out = entry()
    wq, ws = quantize_weight(wt.permute(3, 0, 1, 2))
    ref = conv2d_int8_plain(x, wq, ws, act, None, 1, 1, epilogue, odt).float()
    _sync()
    err = (out.float() - ref).abs().max().item()
    row = {"shape": [b, h, w, cin, cout], "entry": name, "epilogue": epilogue,
           "max_abs_err": err, "tol": 0.0, "max_abs_out": ref.abs().max().item(),
           **_conv_plan_fields(b, h, w, cin, cout, 3, 1, 1, 1, epilogue)}
    if saturate:
        other = conv2d_int8_plain(x, wq, ws, act, None, 1, 1, "tpu", odt)
        row["differs_from_tpu_order"] = bool((other != ref).any().item())
        if not row["differs_from_tpu_order"]:
            raise AssertionError(f"{name} {row['shape']}: the saturated case does not tell "
                                 f"the halo order from the tpu order")
    if timed:
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        ops = 2.0 * b * h * w * cout * 9 * cin
        nbytes = 2.0 * b * h * w * cin + 9.0 * cin * cout + 4.0 * cout + 2.0 * b * h * w * cout
        row["bound_ms"], row["bound_by"] = bound(ops, nbytes, H100_INT8_OPS)
        _timed_against_library(row, lambda: conv2d_int8(x, wq, ws, act, None, 1, 1, epilogue),
                               lambda: F.conv2d(xc, wc, None, 1, 1))
        row["plain_ms"] = time_ms(
            lambda: conv2d_int8_plain(x, wq, ws, act, None, 1, 1, epilogue), reps=3, warmup=1)
        row["library_call"] = "F.conv2d (bf16, cuDNN, channels_last)"
    return _check_row(f"{name} ({epilogue})", row, err, 0.0)


def tma_map_host_cost():
    """Host time of one int8 conv call through its C launcher alone (the
    quantize and the conv), with the int8 activation's TMA map found in the
    launcher's cache (the same workspace every call, as the wrappers pass
    it) against encoded anew (a new pointer every call): the difference is
    the host cost of encoding a map. A 1x1 conv over 64 pixels keeps each
    call's device work to a few us, so the loop measures the host."""
    import torch

    from d3roma_tpu_torch.ops.kernels import _build
    from d3roma_tpu_torch.ops.kernels import conv2d as kconv

    n, pixels, c = 256, 64, 64
    dev = torch.device("cuda", 0)
    # the int8 activation (the quantize's output, the map's tensor) at a new
    # 16-byte offset of the pool for each call, or at the same one
    pool = torch.zeros((16 * (n + 1) + pixels * c,), dtype=torch.int8, device=dev)
    x = torch.zeros((pixels, c), dtype=torch.bfloat16, device=dev)
    wq = torch.zeros((c, 1, 1, c), dtype=torch.int8, device=dev)
    ws = torch.ones(c, device=dev)
    out = torch.empty((pixels, c), dtype=torch.bfloat16, device=dev)
    _, ints = kconv.launch_ints(1, 1, pixels, c, c, 1, 1, 1, 0, 1, "xla", False, dev)
    lib, stream = kconv._library(), _build.current_stream(dev)

    def per_call_us(ptrs):
        _sync()
        t0 = time.perf_counter()
        for p in ptrs:
            _build.check(lib.d3r_conv2d_int8(x.data_ptr(), p, wq.data_ptr(), ws.data_ptr(),
                                             None, out.data_ptr(), None, ints, 0.05, stream),
                         "conv2d_int8")
        us = (time.perf_counter() - t0) / len(ptrs) * 1e6
        _sync()
        return us

    base = pool.data_ptr()
    per_call_us([base] * 16)  # warm: the weight's map and the cached activation map
    cached = per_call_us([base] * n)
    fresh = per_call_us([base + 16 * (i + 1) for i in range(n)])
    row = {"cached_us": cached, "encoded_us": fresh, "encode_us": fresh - cached}
    print(f"  tma map host cost per launch {row}", flush=True)
    return row


def conv_and_fused_bf16_kernel_phase():
    """The bf16 fused attention, the bf16 conv and the int8 conv kernel in
    the TPU kernels' epilogues, through the JAX entry points, against their
    plain versions at the two new paths' shapes (timed) and ragged ones."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8765)
    rows = {"attention_fused_bf16": attention_fused_bf16_cases(gen)}
    rows["conv2d_bf16"] = [_conv_bf16_case(*s, gen, True) for s in (
        (BATCH, 45, 80, 320, 320), (BATCH, 23, 40, 640, 640), (BATCH, 12, 20, 1280, 1280))]
    rows["conv2d_bf16"].append(_conv_bf16_case(BATCH, 23, 40, 640, 640, gen, True, halo=True))
    for shape in ((1, 7, 9, 32, 34), (2, 13, 17, 96, 130)):
        _conv_bf16_case(*shape, gen, False)
        _conv_bf16_case(*shape, gen, False, halo=True)
    rows["conv3x3_flat_tpu"] = [_conv_epilogue_case("conv3x3_flat", "tpu", *s, gen, True)
                                for s in ((BATCH, 45, 80, 320, 320), (BATCH, 23, 40, 1920, 640),
                                          (2 * BATCH, 45, 80, 512, 512))]
    rows["conv3x3_rowtap"] = [_conv_epilogue_case("conv3x3_rowtap", "tpu", BATCH, 45, 80, 320,
                                                  320, gen, True)]
    rows["conv3x3_halo"] = [_conv_epilogue_case("conv3x3_halo", "halo", *s, gen, True)
                            for s in ((BATCH, 45, 80, 320, 320), (BATCH, 23, 40, 640, 640),
                                      (2 * BATCH, H, W, 128, 128), (BATCH, 90, 160, 512, 512))]
    for name, epi in (("conv3x3_flat", "tpu"), ("conv3x3_rowtap", "tpu"),
                      ("conv3x3_halo", "halo")):
        _conv_epilogue_case(name, epi, 1, 7, 9, 32, 34, gen, False)
        _conv_epilogue_case(name, epi, BATCH, 6, 10, 1280, 200, gen, False)  # split K
    rows["conv3x3_halo"].append(
        _conv_epilogue_case("conv3x3_halo", "halo", 1, 6, 10, 1280, 64, gen, False, True))
    rows["tma_map_host_cost"] = tma_map_host_cost()
    _sync()
    return rows


def _schedule():
    from d3roma_tpu_torch.ops.schedules import ScheduleConfig

    return ScheduleConfig(
        num_train_timesteps=1000, beta_schedule="scaled_linear",
        beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
        clip_sample=False, timestep_spacing="leading", steps_offset=1)


def _run_call(pipe, rgb, raw):
    import torch

    def run():
        return pipe(num_inference_steps=STEPS, num_intermediate_images=1,
                    cond_channels="rgb+raw", rgb_images=rgb, sim_disp=raw,
                    generator=torch.Generator(device="cuda").manual_seed(7))
    return run


def _timed_calls(pipe, run, label):
    """Zero the launch counts, make one call (its counts and output are
    kept), then two more: the host's share of a call varies from machine to
    machine, so the median of three is the number kept. Checks the output's
    shape and that it and its disparity are finite. Returns (counts,
    ms/frame)."""
    import torch

    _zero_launches()
    t0 = time.perf_counter()
    out = run()
    _sync()
    walls = [time.perf_counter() - t0]
    counts = _int8_launches()
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        _sync()
        walls.append(time.perf_counter() - t0)
    ms_per_frame = sorted(walls)[1] * 1e3 / BATCH
    disp = pipe.normalizer.denormalize(out.images.float())
    print(f"{label}: {ms_per_frame:.2f} ms/frame, median of "
          f"{[round(w * 1e3 / BATCH, 2) for w in walls]} (batch {BATCH}, {STEPS} steps, "
          f"{H}x{W}); images {tuple(out.images.shape)} in [{out.images.min().item():.4f}, "
          f"{out.images.max().item():.4f}], disparity in [{disp.min().item():.3f}, "
          f"{disp.max().item():.3f}]", flush=True)
    if tuple(out.images.shape) != (BATCH, H, W, 1):
        raise AssertionError(f"{label}: images shape {tuple(out.images.shape)}")
    if not (torch.isfinite(out.images).all() and torch.isfinite(disp).all()):
        raise AssertionError(f"{label}: non-finite pipeline output")
    return counts, ms_per_frame


def _check_counts(label, counts, expected):
    """Print one call's launch counts; fail unless every expected count is
    met and no other kernel launched."""
    others = {k: v for k, v in counts.items() if k not in expected and v}
    print(f"{label}: launches in one call {counts} (expected {expected}, no other)",
          flush=True)
    if any(counts[k] != v for k, v in expected.items()) or others:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {expected}")


def pipeline_phase():
    """The main path at the full SD2.1 geometry. Returns the launch counts
    of one pipeline call and the median ms per frame."""
    import torch

    from d3roma_tpu_torch.models import (
        AutoencoderKL,
        UNet2DCondition,
        init_random_,
        widened_in_channels,
    )
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    unet = UNet2DCondition(in_channels=widened_in_channels("rgb+raw"), out_channels=4,
                           device="cuda")
    vae = AutoencoderKL(device="cuda")
    init_random_(unet, gen)
    init_random_(vae, gen)
    pipe = GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=torch.zeros(1, 2, 1024),
        spec=SamplerSpec("my_ddim", _schedule()),
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1,
                              ch_bounds=(128.0,), ch_gammas=(1.0,)),
        device="cuda",
    ).fast_inference("latency")
    n_unet = sum(p.numel() for p in unet.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    _sync()
    print(f"pipeline: built UNet {n_unet / 1e6:.1f}M + VAE {n_vae / 1e6:.1f}M params "
          f"({next(unet.parameters()).dtype}) in {time.perf_counter() - t0:.1f}s", flush=True)

    rgb = torch.randn((BATCH, H, W, 3), generator=gen, device="cuda") * 0.5
    raw = torch.randn((BATCH, H, W, 1), generator=gen, device="cuda").abs() * 0.5
    run = _run_call(pipe, rgb, raw)
    t0 = time.perf_counter()
    run()
    _sync()
    print(f"pipeline: first call {time.perf_counter() - t0:.2f}s", flush=True)
    counts, ms_per_frame = _timed_calls(pipe, run, "latency")
    _check_counts("latency", counts, {"attention": 10 * STEPS, "geglu": 16 * STEPS})

    profile_phase(run, "latency")

    # One UNet forward through the kernels against the same forward through
    # the plain torch paths (the attention and feed-forward the JAX package
    # runs on XLA when no kernel is taken).
    x = torch.randn((BATCH, H // 8, W // 8, unet.in_channels), generator=gen,
                    device="cuda")
    t = torch.full((BATCH,), 981, device="cuda")
    ctx = torch.zeros((BATCH, 2, 1024), device="cuda")
    with torch.no_grad():
        fast = unet(x, t, ctx)
        unet.set_kernels(use_flash_attention=False, fused_ff=False)
        plain = unet(x, t, ctx)
        unet.set_kernels(use_flash_attention="pallas-self", fused_ff=True)
    rel = ((fast - plain).abs().max() / plain.abs().max()).item()
    print(f"unet forward: kernel path vs plain path max err / max |out| = {rel:.3e} "
          f"(tol {UNET_REL_TOL})", flush=True)
    if not rel <= UNET_REL_TOL:
        raise AssertionError(f"UNet kernel path differs from the plain path: {rel}")
    _sync()
    return pipe, (rgb, raw, gen), counts, ms_per_frame


def _int8_launches():
    from d3roma_tpu_torch.ops.kernels import (
        conv2d_bf16,
        conv2d_int8,
        conv2d_int8_dynamic,
        conv3x3_winograd,
        fused_self_attention_bf16,
        fused_self_attention_int8,
        geglu_ff,
        geglu_ff_int8,
        group_norm_silu,
        mha_attention,
        mha_attention_int8,
        quantize_int8_scalar,
    )

    return {"attention": mha_attention.launches, "geglu": geglu_ff.launches,
            "attention_int8": mha_attention_int8.launches,
            "geglu_int8": geglu_ff_int8.launches, "conv2d_int8": conv2d_int8.launches,
            "conv2d_int8_dynamic": conv2d_int8_dynamic.launches,
            **{f"conv2d_int8_{k}": v for k, v in conv2d_int8.epilogue_launches.items()},
            "quantize": quantize_int8_scalar.launches,
            "attention_fused_int8": fused_self_attention_int8.launches,
            "attention_fused_bf16": fused_self_attention_bf16.launches,
            "conv2d_bf16": conv2d_bf16.launches,
            "winograd": conv3x3_winograd.launches, "groupnorm_silu": group_norm_silu.launches}


def _zero_launches():
    from d3roma_tpu_torch.ops import kernels
    from d3roma_tpu_torch.ops.kernels.conv2d import reset_conv2d_int8_launches

    for fn in (kernels.mha_attention, kernels.geglu_ff, kernels.mha_attention_int8,
               kernels.geglu_ff_int8, kernels.quantize_int8_scalar,
               kernels.fused_self_attention_int8, kernels.fused_self_attention_bf16,
               kernels.conv2d_bf16, kernels.conv3x3_winograd, kernels.group_norm_silu,
               kernels.conv2d_int8_dynamic):
        fn.launches = 0
    reset_conv2d_int8_launches()


def _plain_int8_forward(fn, attention: bool = True):
    """fn() with the int8 kernel wrappers (the attention ones too, unless
    attention=False) replaced by their plain versions: the same arithmetic
    in PyTorch ops, on the card. With attention, the opt-in configuration's
    fused attention, Winograd and fused GroupNorm wrappers and the bf16
    whole-row attention are replaced too; without it they stay kernels,
    like the int8 attention (of the wrappers the forward reaches, the
    static and dynamic conv and the GEGLU kernels are bit-equal to their
    plain versions, the others are not)."""
    from d3roma_tpu_torch.models import layers
    from d3roma_tpu_torch.ops import kernels, quant, winograd

    saved = (layers.mha_attention_int8, layers.geglu_ff_int8, quant.conv2d_int8,
             layers.fused_self_attention_int8, layers.group_norm_silu,
             winograd.conv3x3_winograd, quant.conv2d_int8_dynamic, layers.mha_attention)
    if attention:
        layers.mha_attention_int8 = kernels.mha_attention_int8_plain
        layers.fused_self_attention_int8 = kernels.fused_self_attention_int8_plain
        layers.group_norm_silu = kernels.group_norm_silu_plain
        winograd.conv3x3_winograd = kernels.conv3x3_winograd_plain
        layers.mha_attention = kernels.mha_attention_plain
    layers.geglu_ff_int8 = kernels.geglu_ff_int8_plain
    quant.conv2d_int8 = kernels.conv2d_int8_plain
    quant.conv2d_int8_dynamic = kernels.conv2d_int8_dynamic_plain
    try:
        return fn()
    finally:
        (layers.mha_attention_int8, layers.geglu_ff_int8, quant.conv2d_int8,
         layers.fused_self_attention_int8, layers.group_norm_silu,
         winograd.conv3x3_winograd, quant.conv2d_int8_dynamic, layers.mha_attention) = saved


def bench_default_phase(pipe, inputs):
    """The JAX package's bench default on the same models: static int8 in
    the UNet and the VAE, DeepCache interval 2 at depth 2, calibrated on one
    batch. Returns the launch counts of one call, the median ms/frame and
    the launch counts expected of one call."""
    from d3roma_tpu_torch.pipelines.sampling import uniform_cache_schedule

    rgb, raw, gen = inputs
    t0 = time.perf_counter()
    logs = {}
    pipe.fast_inference("throughput").deepcache(2, depth=2).calibrate(
        gen, [dict(rgb_images=rgb, sim_disp=raw)], cond_channels="rgb+raw",
        num_inference_steps=STEPS, shape_logs=logs)
    _sync()
    print(f"bench default: calibrated in {time.perf_counter() - t0:.2f}s; table lengths "
          f"{ {k: len(v) for k, v in pipe.act_scales.items()} }", flush=True)
    pattern = uniform_cache_schedule(2, STEPS)
    # the int8 conv kernel serves every quantized conv and dense site
    convs = {k: sum(1 for kind, _ in v if kind in ("conv", "dot")) for k, v in logs.items()}
    expected = {
        # full pass: 10 self-attention sites of >= 512 tokens and 16 GEGLUs;
        # shallow pass at depth 2: the same 10 sites and 10 of the GEGLUs;
        # the VAE's mid attention in the encode and in the decode
        "attention_int8": 10 * pattern.count("F") + 10 * pattern.count("S") + 2,
        "geglu_int8": 16 * pattern.count("F") + 10 * pattern.count("S"),
        # one launch per quantized conv or dense site visited, from the
        # capture logs
        "conv2d_int8": (convs["vae_encode"] + convs["unet"] * pattern.count("F")
                        + convs["unet_cached"] * pattern.count("S") + convs["vae_decode"]),
    }
    if (expected["attention_int8"], expected["geglu_int8"]) != (102, 130):
        raise AssertionError(f"expected launches {expected} for pattern {pattern}")

    run = _run_call(pipe, rgb, raw)
    t0 = time.perf_counter()
    run()
    _sync()
    print(f"bench default: first call {time.perf_counter() - t0:.2f}s (pattern {pattern})",
          flush=True)
    # one activation quantization in front of each int8 conv, dense and GEGLU
    expected["quantize"] = expected["conv2d_int8"] + expected["geglu_int8"]
    counts, ms_per_frame = _timed_calls(pipe, run, "bench default")
    _check_counts("bench default", counts,
                  dict(expected, conv2d_int8_xla=expected["conv2d_int8"]))

    profile_phase(run, "bench default")
    _compare_int8_forwards(pipe, gen, "static", "int8")
    return counts, ms_per_frame, expected, _site_visits(logs, pattern)


def _site_visits(logs, pattern):
    """Visits of one call to the quantized sites of each kind ("dot",
    "conv", "attn", "geglu"), from the capture logs of a calibration with
    the call's F/S pattern."""
    passes = {"vae_encode": 1, "unet": pattern.count("F"), "unet_cached": pattern.count("S"),
              "vae_decode": 1}
    return {kd: sum(n * sum(1 for kind, _ in logs[t] if kind == kd) for t, n in passes.items())
            for kd in ("dot", "conv", "attn", "geglu")}


def _compare_int8_forwards(pipe, gen, quant, label):
    """One full and one shallow UNet forward under `quant`, each replaying
    its table, through the kernels against the same forwards through their
    plain versions. The conv (and dense), GEGLU and quantize kernels are
    bit-equal to their plain versions; the attention kernels (and the
    opt-in path's Winograd and fused GroupNorm) are not (sums in another
    order, expf in the last place), and a last-place difference before a
    quantization moves that value by one int8 quantum, which the following
    layers amplify to the level of the int8 noise itself. So: (1) with only
    the bit-equal kernels swapped, the forwards must agree to 1e-3 of
    max |out| (expected: equal); (2) with every kernel swapped, the
    difference must stay within the int8 noise: two int8 forwards whose
    roundings have come apart differ by up to ~sqrt(2) times the distance
    of one from the float forward, so no more than twice the same forward's
    distance from its bf16 version (int8 off, the other kernels as set,
    except that the fused self-attention route is swapped for "pallas-self",
    so that no kernel checked here sets its own yardstick)."""
    import torch

    from d3roma_tpu_torch.ops.quant import replay_act_scales

    unet = pipe.unet
    x = torch.randn((BATCH, H // 8, W // 8, unet.in_channels), generator=gen, device="cuda")
    ctx = torch.zeros((BATCH, 2, 1024), device="cuda")
    tables = pipe.act_scales if pipe.act_scales and unet.quant in ("static", "mxu", "halo",
                                                                   "wino_static") else None

    def forwards(replay=True):
        with torch.no_grad():
            if not (replay and tables):
                full, trunk = unet(x, 981, ctx, return_trunk=True)
                return full, unet(x, 881, ctx, cached_trunk=trunk)
            with replay_act_scales(tables["unet"]):
                full, trunk = unet(x, 981, ctx, return_trunk=True)
            with replay_act_scales(tables["unet_cached"]):
                shallow = unet(x, 881, ctx, cached_trunk=trunk)
        return full, shallow

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    fast = forwards()
    same_attention = _plain_int8_forward(forwards, attention=False)
    plain = _plain_int8_forward(forwards)
    route = unet.use_flash_attention
    unet.set_quant(False)
    unet.set_kernels(use_flash_attention="pallas-self" if route == "fused" else route)
    bf16 = forwards(replay=False)
    unet.set_quant(quant)
    unet.set_kernels(use_flash_attention=route)
    for i, name in enumerate(("full", "shallow")):
        r1, r2, noise = rel(fast[i], same_attention[i]), rel(fast[i], plain[i]), rel(
            fast[i], bf16[i])
        print(f"unet {name} pass ({label}), max err / max |out|: kernels vs plain versions "
              f"of the bit-equal kernels {r1:.3e} (tol 1e-3); all plain {r2:.3e} (tol: "
              f"twice the int8 noise, {noise:.3e} from the bf16 forward)", flush=True)
        if not (r1 <= 1e-3 and r2 <= 2 * noise):
            raise AssertionError(f"UNet {name} pass ({label}): kernel path differs from the "
                                 f"plain versions: {r1}, {r2} (int8 noise {noise})")
    _sync()


def latency_fused_phase(pipe, inputs):
    """The latency path with the fused self-attention (the JAX bench's
    BENCH_QUANT=0 BENCH_FLASH=4): fast_inference("latency"), then
    set_kernels(use_flash_attention="fused"). The bf16 fused kernel takes
    the 920-token sites, the only ones its gate admits at itemsize 2; the
    3600-token sites take the flash route (the whole-row bf16 kernel); the
    240- and 60-token sites stay plain. Returns the launch counts of one
    call and the median ms/frame."""
    import torch

    from d3roma_tpu_torch.models import layers
    from d3roma_tpu_torch.ops import kernels

    rgb, raw, gen = inputs
    pipe.fast_inference("latency")
    pipe.unet.set_kernels(use_flash_attention="fused")
    run = _run_call(pipe, rgb, raw)
    t0 = time.perf_counter()
    run()
    _sync()
    print(f"latency-fused: first call {time.perf_counter() - t0:.2f}s", flush=True)
    counts, ms_per_frame = _timed_calls(pipe, run, "latency-fused")
    # per pass: 5 self-attention sites of 920 tokens (down block 1, up block
    # 2), 5 of 3600 (down block 0, up block 3), 16 GEGLUs; no DeepCache
    _check_counts("latency-fused", counts, {"attention_fused_bf16": 5 * STEPS,
                                            "attention": 5 * STEPS, "geglu": 16 * STEPS})
    # The host's share of a call moves more from run to run than between
    # the two paths, so latency and latency-fused are also timed in turns
    # on the same models (L F F L L F F L); only these medians compare them.
    turns = {"pallas-self": [], "fused": []}
    for route in ("pallas-self", "fused", "fused", "pallas-self") * 2:
        pipe.unet.set_kernels(use_flash_attention=route)
        t0 = time.perf_counter()
        run()
        _sync()
        turns[route].append((time.perf_counter() - t0) * 1e3 / BATCH)
    for route, label in (("pallas-self", "latency"), ("fused", "latency-fused")):
        print(f"in turns: {label} {statistics.median(turns[route]):.2f} ms/frame, median of "
              f"{[round(t, 2) for t in turns[route]]}", flush=True)

    pipe.unet.set_kernels(use_flash_attention="fused")  # the turns end on latency's route
    profile_phase(run, "latency-fused")

    # One UNet forward through the kernels against the same forward through
    # their plain versions (the same arithmetic in PyTorch ops).
    unet = pipe.unet
    x = torch.randn((BATCH, H // 8, W // 8, unet.in_channels), generator=gen, device="cuda")
    ctx = torch.zeros((BATCH, 2, 1024), device="cuda")
    saved = (layers.fused_self_attention_bf16, layers.mha_attention, layers.geglu_ff)
    with torch.no_grad():
        fast = unet(x, 981, ctx)
        (layers.fused_self_attention_bf16, layers.mha_attention,
         layers.geglu_ff) = (kernels.fused_self_attention_bf16_plain,
                             kernels.mha_attention_plain, kernels.geglu_ff_plain)
        try:
            plain = unet(x, 981, ctx)
        finally:
            layers.fused_self_attention_bf16, layers.mha_attention, layers.geglu_ff = saved
    rel = ((fast - plain).abs().max() / plain.abs().max()).item()
    print(f"unet forward (latency-fused): kernels vs plain versions max err / max |out| = "
          f"{rel:.3e} (tol {UNET_REL_TOL})", flush=True)
    if not rel <= UNET_REL_TOL:
        raise AssertionError(f"latency-fused UNet kernel path differs from plain: {rel}")
    pipe.unet.set_kernels(use_flash_attention="pallas-self")
    _sync()
    return counts, ms_per_frame


def _conv_route_dry_pass(pipe, run, mode):
    """One call with a hook on every quantized conv that records the port's
    route under `mode` (the gate of ops/quant.py's int8_conv_mxu or
    int8_conv_halo) without counting launches. Returns (admitted, refused,
    {site: route})."""
    import torch

    from d3roma_tpu_torch.models.layers import Conv2d
    from d3roma_tpu_torch.ops.kernels import conv3x3_supported, halo_conv_supported
    from d3roma_tpu_torch.ops.winograd import conv_hwio_shape

    calls = {"kernel": 0, "static": 0}
    table = {}

    def hook(mod, args):
        shape = tuple(args[0].shape)
        pad = ((mod.padding[0],) * 2, (mod.padding[1],) * 2)
        gate = (conv3x3_supported(shape, conv_hwio_shape(mod.weight), mod.stride, pad,
                                  torch.int8) if mode == "mxu" else
                halo_conv_supported(shape, conv_hwio_shape(mod.weight), mod.stride, pad))
        calls["kernel" if gate else "static"] += 1
        table[("conv", mod.kernel_size[0]) + shape + (mod.weight.shape[0], mod.stride[0])] = (
            f"{mode} kernel" if gate else "static int8")

    hooks = [m.register_forward_pre_hook(hook)
             for m in list(pipe.unet.modules()) + list(pipe.vae.modules())
             if isinstance(m, Conv2d) and m.quant == mode]
    try:
        run()
        _sync()
    finally:
        for hk in hooks:
            hk.remove()
    return calls["kernel"], calls["static"], table


def conv_routes_phase(pipe, inputs, bench_expected):
    """The JAX bench's BENCH_QUANT=halo and BENCH_QUANT=mxu on the bench
    default's calibrated models: set_quant("halo"), then set_quant("mxu"),
    on the UNet and the VAE, replaying the bench default's tables (neither
    route changes the taps' call order). A dry pass logs each conv's route;
    the int8 conv launches of one call must split into the mode's epilogue
    (the sites its gate admits) and "xla" (the rest, the dense sites
    included), summing to the bench default's count; the attention, GEGLU
    and quantize launches are the bench default's. Returns {mode: (counts,
    ms/frame)}."""
    rgb, raw, gen = inputs
    results = {}
    for mode, epilogue in (("halo", "halo"), ("mxu", "tpu")):
        pipe.set_quant(mode)
        run = _run_call(pipe, rgb, raw)
        t0 = time.perf_counter()
        admitted, refused, table = _conv_route_dry_pass(pipe, run, mode)
        print(f"{mode}: routing dry pass (first call, {time.perf_counter() - t0:.2f}s): "
              f"{admitted} conv visits on the {mode} kernel, {refused} on the static conv",
              flush=True)
        for site, route in sorted(table.items(), key=str):
            print(f"  route {site}: {route}", flush=True)
        if admitted <= 0:
            raise AssertionError(f"{mode}: no conv visit takes the {mode} kernel")
        counts, ms_per_frame = _timed_calls(pipe, run, mode)
        _check_counts(mode, counts, dict(
            bench_expected, **{f"conv2d_int8_{epilogue}": admitted,
                               "conv2d_int8_xla": bench_expected["conv2d_int8"] - admitted}))
        profile_phase(run, mode)
        _compare_int8_forwards(pipe, gen, mode, mode)
        results[mode] = (counts, ms_per_frame)
    pipe.set_quant("static")
    return results


def _wino_dry_pass(pipe, run):
    """One call with a hook on every conv under quant="wino" that records
    the port's route (ops/winograd.py: the Winograd kernel, once per batch
    chunk of wino_eligible, inside the liveness cap; the float conv outside
    it). Returns ({route: visits}, {site: route})."""
    from d3roma_tpu_torch.models.layers import Conv2d
    from d3roma_tpu_torch.ops.winograd import conv_hwio_shape, wino_eligible

    calls = {"kernel": 0, "float": 0}
    table = {}

    def hook(mod, args):
        shape = tuple(args[0].shape)
        pad = ((mod.padding[0],) * 2, (mod.padding[1],) * 2)
        chunk = wino_eligible(shape, conv_hwio_shape(mod.weight), mod.stride, pad)
        if chunk is None:
            calls["float"] += 1
        else:
            calls["kernel"] += -(-shape[0] // chunk)
        table[("conv", mod.kernel_size[0]) + shape + (mod.weight.shape[0], mod.stride[0])] = (
            "float" if chunk is None else f"kernel (chunk {chunk})")

    hooks = [m.register_forward_pre_hook(hook)
             for m in list(pipe.unet.modules()) + list(pipe.vae.modules())
             if isinstance(m, Conv2d) and m.quant == "wino"]
    try:
        run()
        _sync()
    finally:
        for hk in hooks:
            hk.remove()
    return calls, table


def dynamic_paths_phase(pipe, inputs, visits):
    """The JAX bench's BENCH_QUANT=1 (quantize_int8(): dynamic int8 in the
    UNet and the VAE), BENCH_QUANT=dense and BENCH_QUANT=wino on the same
    models, with the bench's kernels (whole-row attention at self-attention
    sites, fused GEGLU, DeepCache interval 2 at depth 2), no calibration.
    The dynamic paths take the unfused feed-forward (two dense layers
    where the static path runs one fused GEGLU), so their expected dynamic
    int8 launches come from the bench default's capture logs (`visits`):
    every dense and conv visit, plus two per GEGLU visit ("all"), or the
    dense ones only ("dense"). One "all" call runs under
    torch.cuda.set_sync_debug_mode("error"): a host synchronization in a
    dynamic op (or anywhere in the call) fails it. Returns {mode: (counts,
    ms/frame)}."""
    import torch

    from d3roma_tpu_torch.pipelines.sampling import uniform_cache_schedule

    rgb, raw, gen = inputs
    pattern = uniform_cache_schedule(2, STEPS)
    pipe.act_scales = None
    pipe.unet.set_kernels(use_flash_attention="pallas-self", fused_ff=True, fused_norm=False)
    pipe.vae.set_kernels(fused_norm=False)
    pipe.deepcache(2, depth=2)
    attention = 10 * pattern.count("F") + 10 * pattern.count("S")  # the UNet's sites
    results = {}
    for mode, label in ((True, "all"), ("dense", "dense"), ("wino", "wino")):
        if mode is True:
            pipe.quantize_int8()
        else:
            pipe.set_quant(mode)
        run = _run_call(pipe, rgb, raw)
        t0 = time.perf_counter()
        if mode == "wino":
            routes, table = _wino_dry_pass(pipe, run)
            print(f"wino: routing dry pass (first call, {time.perf_counter() - t0:.2f}s): "
                  f"{routes}", flush=True)
            for site, route in sorted(table.items(), key=str):
                print(f"  route {site}: {route}", flush=True)
            if routes["kernel"] <= 0:
                raise AssertionError("wino: no conv visit takes the Winograd kernel")
            expected = {"attention": attention, "winograd": routes["kernel"]}
        else:
            run()
            _sync()
            print(f"{label}: first call {time.perf_counter() - t0:.2f}s", flush=True)
            dense = visits["dot"] + 2 * visits["geglu"]
            if mode is True:
                expected = {"attention_int8": attention + 2,
                            "conv2d_int8_dynamic": dense + visits["conv"]}
            else:
                expected = {"attention": attention, "conv2d_int8_dynamic": dense}
        if mode is True:
            torch.cuda.set_sync_debug_mode("error")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            _sync()
            print("all: one call under set_sync_debug_mode('error'): no host synchronization",
                  flush=True)
        counts, ms_per_frame = _timed_calls(pipe, run, label)
        _check_counts(label, counts, expected)
        profile_phase(run, label)
        if mode == "wino":
            _compare_float_forwards(pipe, gen, label)
        else:
            _compare_int8_forwards(pipe, gen, mode, label)
        results[label] = (counts, ms_per_frame)
    return results


def _compare_float_forwards(pipe, gen, label):
    """One full and one shallow UNet forward through the kernels against the
    same forwards through their plain versions (no int8 on the path: the
    Winograd and bf16 attention kernels against their plain versions,
    UNET_REL_TOL)."""
    import torch

    unet = pipe.unet
    x = torch.randn((BATCH, H // 8, W // 8, unet.in_channels), generator=gen, device="cuda")
    ctx = torch.zeros((BATCH, 2, 1024), device="cuda")

    def forwards():
        with torch.no_grad():
            full, trunk = unet(x, 981, ctx, return_trunk=True)
            return full, unet(x, 881, ctx, cached_trunk=trunk)

    fast = forwards()
    plain = _plain_int8_forward(forwards)
    for i, name in enumerate(("full", "shallow")):
        rel = ((fast[i] - plain[i]).abs().max() / plain[i].abs().max()).item()
        print(f"unet {name} pass ({label}): kernel path vs plain path max err / max |out| = "
              f"{rel:.3e} (tol {UNET_REL_TOL})", flush=True)
        if not rel <= UNET_REL_TOL:
            raise AssertionError(f"UNet {name} pass ({label}) differs from the plain path: {rel}")
    _sync()


def vae8_phase(pipe, inputs):
    """The JAX bench's BENCH_QUANT=vae8 on the same models: a bf16 UNet and a
    static int8 VAE, DeepCache interval 2 at depth 2, calibrated. As in the
    JAX package, calibrate() switches a UNet in no static mode to "static"
    (with the VAE), so the calibrated path is the bench default's: its
    launch counts, from this calibration's own capture logs. Returns
    (counts, ms/frame)."""
    from d3roma_tpu_torch.pipelines.sampling import uniform_cache_schedule

    rgb, raw, gen = inputs
    pipe.act_scales = None
    pipe.set_quant(False)
    pipe.vae.set_quant("static")
    logs = {}
    t0 = time.perf_counter()
    pipe.deepcache(2, depth=2).calibrate(
        gen, [dict(rgb_images=rgb, sim_disp=raw)], cond_channels="rgb+raw",
        num_inference_steps=STEPS, shape_logs=logs)
    _sync()
    print(f"vae8: calibrated in {time.perf_counter() - t0:.2f}s; UNet quant after calibrate "
          f"{pipe.unet.quant!r}, VAE {pipe.vae.quant!r}", flush=True)
    if (pipe.unet.quant, pipe.vae.quant) != ("static", "static"):
        raise AssertionError("vae8: calibrate() left the UNet or the VAE out of static int8")
    pattern = uniform_cache_schedule(2, STEPS)
    v = _site_visits(logs, pattern)
    expected = {"attention_int8": 10 * pattern.count("F") + 10 * pattern.count("S") + 2,
                "geglu_int8": v["geglu"], "conv2d_int8": v["conv"] + v["dot"]}
    expected.update(quantize=expected["conv2d_int8"] + expected["geglu_int8"],
                    conv2d_int8_xla=expected["conv2d_int8"])
    run = _run_call(pipe, rgb, raw)
    run()
    _sync()
    counts, ms_per_frame = _timed_calls(pipe, run, "vae8")
    _check_counts("vae8", counts, expected)
    _compare_int8_forwards(pipe, gen, "static", "vae8")
    return counts, ms_per_frame


# the keys of the JAX bench's line (BENCH_r05.json) at the default setting,
# and the torch bench's own
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "config", "batch", "ms_per_frame",
              "quant", "deepcache_interval", "deepcache_depth", "tflop_per_frame",
              "tflops_sustained", "mfu_bf16_peak", "mfu_int8_peak", "device")
# the keys of the JAX bench's BENCH_MODEL=pixel line (bench.py: no DeepCache,
# clipping or MFU keys there) and the torch bench's own
PIXEL_BENCH_KEYS = BENCH_KEYS[:8] + ("device",)


def bench_phase(pixel_only: bool = False):
    """`python -m d3roma_tpu_torch.bench` as a user runs it, at batch 2 with
    3 timed calls, its records and calibrated scales in a temporary
    directory: at the default setting (static int8, 2d2, calibrated), with
    BENCH_CLIP_PCT=0.999 (quantile calibration, clipped scales) and with
    BENCH_MODEL=pixel (only this one with `pixel_only`). Each must exit 0
    and print one JSON line with every key of the JAX bench's line at its
    setting (and act_clip_pct with the clipping), value > 0. Returns the
    lines."""
    import tempfile

    runs = (("default", {}), ("clip 0.999", {"BENCH_CLIP_PCT": "0.999"}),
            ("pixel", {"BENCH_MODEL": "pixel"}))
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in runs[2:] if pixel_only else runs:
            env = dict(os.environ)
            for k in ("BENCH_QUANT", "BENCH_DEEPCACHE", "BENCH_CALIB", "BENCH_STEPS",
                      "BENCH_RECORDS", "BENCH_MODEL"):
                env.pop(k, None)
            env.update(BENCH_BATCH=str(BATCH), BENCH_REPS="3", BENCH_CACHE_DIR=tmp, **extra)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "d3roma_tpu_torch.bench"], env=env,
                                  capture_output=True, text=True, timeout=600)
            out = proc.stdout.strip().splitlines()
            print(f"bench ({label}): exit {proc.returncode} in {time.perf_counter() - t0:.1f}s; "
                  f"{out[-1] if out else ''}", flush=True)
            for ln in proc.stderr.strip().splitlines()[-3:]:
                print(f"  stderr: {ln}", flush=True)
            if proc.returncode != 0 or not out:
                raise AssertionError(f"bench ({label}) failed: {proc.stderr[-2000:]}")
            line = json.loads(out[-1])
            if label == "pixel":
                keys = PIXEL_BENCH_KEYS
                if set(line) != set(keys):
                    raise AssertionError(f"bench (pixel): keys {sorted(line)}, want {keys}")
            else:
                keys = BENCH_KEYS + (("act_clip_pct",) if extra else ())
            missing = [k for k in keys if k not in line]
            if missing or not line["value"] > 0 or line["batch"] != BATCH:
                raise AssertionError(f"bench ({label}): missing {missing} or bad line {line}")
            lines[label] = line
    return lines


def _routing_dry_pass(pipe, run):
    """One call with a hook on every Winograd-capable conv and every
    GroupNormSiLU that records the port's own routing decisions (the
    wino_static route, the fused GroupNorm gate) without counting launches.
    Returns (Winograd calls, fused GroupNorm calls, {site: route})."""
    from d3roma_tpu_torch.models.layers import Conv2d, GroupNormSiLU
    from d3roma_tpu_torch.ops.kernels import group_norm_silu_supported
    from d3roma_tpu_torch.ops.winograd import conv_hwio_shape, wino_static_route

    calls = {"winograd": 0, "groupnorm_silu": 0}
    table = {}

    def conv_hook(mod, args):
        shape = tuple(args[0].shape)
        pad = ((mod.padding[0],) * 2, (mod.padding[1],) * 2)
        chunk = wino_static_route(shape, conv_hwio_shape(mod.weight), mod.stride, pad)
        if chunk is not None:
            calls["winograd"] += -(-shape[0] // chunk)
        table[("conv", mod.kernel_size[0]) + shape + (mod.weight.shape[0], mod.stride[0])] = (
            "static int8" if chunk is None else f"winograd (chunk {chunk})")

    def gn_hook(mod, args):
        ok = group_norm_silu_supported(args[0].shape, args[0].dtype)
        calls["groupnorm_silu"] += int(ok)
        table[("groupnorm",) + tuple(args[0].shape)] = "fused" if ok else "unfused"

    hooks = []
    for m in list(pipe.unet.modules()) + list(pipe.vae.modules()):
        if isinstance(m, Conv2d) and m.quant == "wino_static":
            hooks.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, GroupNormSiLU) and m.fused:
            hooks.append(m.register_forward_pre_hook(gn_hook))
    try:
        run()
        _sync()
    finally:
        for hk in hooks:
            hk.remove()
    return calls["winograd"], calls["groupnorm_silu"], table


def opt_in_phase(pipe, inputs):
    """The JAX package's opt-in kernel configuration on the same models
    (the JAX bench's BENCH_QUANT=wino_static BENCH_FUSED_GN=1 BENCH_FLASH=4):
    fast_inference("wino").fuse_norms(), the fused self-attention, DeepCache
    interval 2 at depth 2, calibrated on one batch. Returns the launch counts
    of one call and the median ms/frame."""
    from d3roma_tpu_torch.pipelines.sampling import uniform_cache_schedule

    rgb, raw, gen = inputs
    t0 = time.perf_counter()
    logs = {}
    pipe.fast_inference("wino").fuse_norms()
    pipe.unet.set_kernels(use_flash_attention="fused")
    pipe.deepcache(2, depth=2).calibrate(
        gen, [dict(rgb_images=rgb, sim_disp=raw)], cond_channels="rgb+raw",
        num_inference_steps=STEPS, shape_logs=logs)
    _sync()
    kinds = {k: {kd: sum(1 for kind, _ in v if kind == kd) for kd in ("dot", "conv", "attn",
                                                                      "geglu")}
             for k, v in logs.items()}
    print(f"opt-in: calibrated in {time.perf_counter() - t0:.2f}s; taps by kind {kinds}",
          flush=True)
    pattern = uniform_cache_schedule(2, STEPS)

    run = _run_call(pipe, rgb, raw)
    t0 = time.perf_counter()
    wino_calls, gn_calls, table = _routing_dry_pass(pipe, run)
    print(f"opt-in: routing dry pass (first call, {time.perf_counter() - t0:.2f}s): "
          f"{wino_calls} Winograd and {gn_calls} fused GroupNorm calls", flush=True)
    for site, route in sorted(table.items(), key=str):
        print(f"  route {site}: {route}", flush=True)
    convs = {k: v["conv"] + v["dot"] for k, v in kinds.items()}
    expected = {
        # every self-attention site (16 per full pass, 10 in the depth-2
        # shallow pass) takes the fused kernel; the VAE's mid attention
        # (encode and decode) the whole-row int8 kernel
        "attention_fused_int8": 16 * pattern.count("F") + 10 * pattern.count("S"),
        "attention_int8": 2,
        "geglu_int8": 16 * pattern.count("F") + 10 * pattern.count("S"),
        "conv2d_int8": (convs["vae_encode"] + convs["unet"] * pattern.count("F")
                        + convs["unet_cached"] * pattern.count("S") + convs["vae_decode"]),
        "winograd": wino_calls,
        "groupnorm_silu": gn_calls,
    }
    if (expected["attention_fused_int8"], expected["geglu_int8"]) != (130, 130):
        raise AssertionError(f"expected launches {expected} for pattern {pattern}")
    # one activation quantization in front of each int8 conv, dense, GEGLU
    # and fused attention
    expected["quantize"] = (expected["conv2d_int8"] + expected["geglu_int8"]
                            + expected["attention_fused_int8"])

    if min(expected.values()) <= 0:
        raise AssertionError(f"opt-in: expected launches {expected}")
    counts, ms_per_frame = _timed_calls(pipe, run, "opt-in")
    _check_counts("opt-in", counts, dict(expected, conv2d_int8_xla=expected["conv2d_int8"]))

    profile_phase(run, "opt-in")
    _compare_int8_forwards(pipe, gen, "wino_static", "opt-in")
    return counts, ms_per_frame


PIXEL_H, PIXEL_W = 368, 640  # the JAX bench's pixel inputs: 360 padded to a multiple of 16
PIXEL_INTERMEDIATES = 5
# bf16 UNet2D forward against the same (bf16-valued) weights in fp32 with
# TF32 off: bf16 rounding through the UNet, 8.2e-3 of max |out| at full
# widths and 368x640 on an H100 (1.2e-2 at 48x80 on the CPU)
PIXEL_BF16_REL_TOL = 5e-2
# SSI denormalize on the card against the CPU (sums of 235,520 pixels in
# another order; the RANSAC subsets are the same explicit indices)
SSI_REL_TOL = 1e-3


def _pixel_pipeline():
    """The JAX bench's pixel setting (bench.py::bench_pixel): UNet2D at its
    full widths, random weights from a seed, my_ddpm over 128 squaredcos
    steps (prediction "sample", clipped), SSI normalizer, guidance off, in
    bf16."""
    import torch

    from d3roma_tpu_torch.guidance import FlowGuidance
    from d3roma_tpu_torch.models import UNet2D, init_random_, pixel_in_channels
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.ops.schedules import ScheduleConfig
    from d3roma_tpu_torch.pipelines import GuidedDiffusionPipeline, SamplerSpec

    unet = UNet2D(in_channels=pixel_in_channels("rgb+raw", 1), out_channels=1, device="cuda")
    init_random_(unet, torch.Generator(device="cuda").manual_seed(0))
    sched = ScheduleConfig(num_train_timesteps=128, beta_schedule="squaredcos_cap_v2",
                           prediction_type="sample", clip_sample=True)
    return GuidedDiffusionPipeline(
        unet=unet, spec=SamplerSpec("my_ddpm", sched),
        guidance=FlowGuidance(flow_guidance_weight=0.0),
        normalizer=Normalizer(ssi=True, safe_ssi=False), device="cuda").half_precision()


def _pixel_timed_calls(pipe, run, label):
    """Zero the launch counts, make one call (its counts and output kept),
    then two more; ms/frame is the median of the three. Checks the shapes
    and that the images and intermediates are finite and in [-1, 1].
    Returns (counts, ms/frame, peak device memory in bytes of the first
    call)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    out = run()
    _sync()
    walls = [time.perf_counter() - t0]
    counts = _int8_launches()
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        _sync()
        walls.append(time.perf_counter() - t0)
    ms_per_frame = sorted(walls)[1] * 1e3 / BATCH
    img, inter = out.images, out.intermediates
    print(f"{label}: {ms_per_frame:.2f} ms/frame, median of "
          f"{[round(w * 1e3 / BATCH, 2) for w in walls]} (batch {BATCH}, {STEPS} steps, "
          f"{PIXEL_H}x{PIXEL_W}); images {tuple(img.shape)} in [{img.min().item():.4f}, "
          f"{img.max().item():.4f}], intermediates {tuple(inter.shape)}; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if (tuple(img.shape) != (BATCH, PIXEL_H, PIXEL_W, 1)
            or tuple(inter.shape) != (PIXEL_INTERMEDIATES, BATCH, PIXEL_H, PIXEL_W, 1)):
        raise AssertionError(f"{label}: shapes {tuple(img.shape)}, {tuple(inter.shape)}")
    for t in (img, inter):
        if not (torch.isfinite(t).all() and t.abs().max() <= 1.0):
            raise AssertionError(f"{label}: output not finite or outside [-1, 1]")
    return counts, ms_per_frame, peak


def _pixel_dry_pass(pipe, run):
    """One call with hooks that record the port's own routing: each dynamic
    int8 conv and dense visit, each fused GroupNorm visit its gate admits.
    Returns ({"conv", "dense", "groupnorm_silu"} visits, {site: route}, the
    set of (shape, dtype, groups, parameter dtype) the fused GroupNorm
    takes)."""
    from d3roma_tpu_torch.models.layers import Conv2d, GroupNormSiLU, Linear
    from d3roma_tpu_torch.ops.kernels import group_norm_silu_supported
    from d3roma_tpu_torch.ops.quant import DYNAMIC_CONV_MODES, DYNAMIC_DENSE_MODES

    visits = {"conv": 0, "dense": 0, "groupnorm_silu": 0}
    table, gn_sites = {}, set()

    def hook(kind):
        def pre(mod, args):
            shape = tuple(args[0].shape)
            if kind == "groupnorm_silu":
                ok = group_norm_silu_supported(shape, args[0].dtype)
                visits[kind] += int(ok)
                table[("groupnorm",) + shape] = "fused" if ok else "unfused"
                if ok:
                    gn_sites.add((shape, str(args[0].dtype).split(".")[-1], mod.groups,
                                  str(mod.weight.dtype).split(".")[-1]))
            else:
                visits[kind] += 1
                table[(kind,) + shape] = "dynamic int8"
        return pre

    hooks = []
    for m in pipe.unet.modules():
        if isinstance(m, Conv2d) and m.quant in DYNAMIC_CONV_MODES:
            hooks.append(m.register_forward_pre_hook(hook("conv")))
        elif isinstance(m, Linear) and m.quant in DYNAMIC_DENSE_MODES:
            hooks.append(m.register_forward_pre_hook(hook("dense")))
        elif isinstance(m, GroupNormSiLU) and m.fused:
            hooks.append(m.register_forward_pre_hook(hook("groupnorm_silu")))
    try:
        run()
        _sync()
    finally:
        for hk in hooks:
            hk.remove()
    return visits, table, gn_sites


def _pixel_ssi_check(out, disp, mask):
    """SSI denormalize of the pipeline's images on the card against the
    same on the CPU: least squares against the raw disparity, and RANSAC
    with explicit subsets drawn on the host against an affine image of the
    output (scale 20, shift 30, noise, a fifth of the pixels outliers by
    +-15), where it must recover the map on the inliers."""
    import torch

    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.ops.scale_shift import ransac_sizes

    y = out.images.float()
    n_sample, _ = ransac_sizes(PIXEL_H * PIXEL_W)
    gen = torch.Generator().manual_seed(3)
    subsets = torch.stack([torch.randperm(PIXEL_H * PIXEL_W, generator=gen)[:n_sample]
                           for _ in range(10)])
    noise = torch.randn(y.shape, generator=gen).to(y.device) * 0.1
    outliers = (torch.rand(y.shape, generator=gen) < 0.2).to(y.device)
    sign = torch.randint(0, 2, y.shape, generator=gen).to(y.device) * 2.0 - 1.0
    affine = 20.0 * y + 30.0 + noise + 15.0 * sign * outliers
    errs = {}
    for label, norm, target, kw in (
            ("lsq", Normalizer(ssi=True, safe_ssi=False), disp, {}),
            ("ransac", Normalizer(ssi=True, safe_ssi=True), affine, {"subsets": subsets})):
        t0 = time.perf_counter()
        gpu = norm.denormalize(y, target, mask, **{k: v.cuda() for k, v in kw.items()})
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = norm.denormalize(y.cpu(), target.cpu(), mask.cpu(), **kw)
        errs[label] = ((gpu.cpu() - cpu).abs().max() / cpu.abs().max()).item()
        print(f"pixel SSI denormalize ({label}): card vs CPU max err / max |ref| = "
              f"{errs[label]:.3e} (tol {SSI_REL_TOL}); {ms:.1f} ms on the card; disparity in "
              f"[{cpu.min().item():.3f}, {cpu.max().item():.3f}]", flush=True)
        if not (torch.isfinite(gpu).all() and errs[label] <= SSI_REL_TOL):
            raise AssertionError(f"SSI denormalize ({label}) on the card differs: {errs[label]}")
    # RANSAC found the scale: the inliers' disparity within the noise
    fit = Normalizer(ssi=True, safe_ssi=True).denormalize(y, affine, mask, subsets=subsets.cuda())
    inl = mask & ~outliers
    if not (fit - (affine - 15.0 * sign * outliers))[inl].abs().max() < 1.0:
        raise AssertionError("SSI RANSAC on the card did not recover the affine map")
    return errs


def pixel_phase():
    """The pixel family at the JAX bench's setting, batch 2: bf16, then
    quantize_int8().fuse_norms() on a copy. Returns a summary dict."""
    import copy

    import torch

    from d3roma_tpu_torch.ops.normalizer import Normalizer

    t0 = time.perf_counter()
    pipe = _pixel_pipeline()
    n = sum(p.numel() for p in pipe.unet.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    rgb = torch.randn((BATCH, PIXEL_H, PIXEL_W, 3), generator=gen, device="cuda") * 0.5
    disp = torch.rand((BATCH, PIXEL_H, PIXEL_W, 1), generator=gen, device="cuda") * 60 + 5
    mask = torch.rand((BATCH, PIXEL_H, PIXEL_W, 1), generator=gen, device="cuda") > 0.3
    disp = torch.where(mask, disp, torch.zeros_like(disp))
    raw, low, up = Normalizer(ssi=True).normalize(disp, mask)  # the condition, SSI-normalized
    _sync()
    print(f"pixel: built UNet2D {n / 1e6:.1f}M params (bf16) in {time.perf_counter() - t0:.1f}s;"
          f" raw windows {[round(v, 2) for v in low.flatten().tolist()]} .. "
          f"{[round(v, 2) for v in up.flatten().tolist()]}", flush=True)

    def run_of(p):
        def run():
            return p(num_inference_steps=STEPS, num_intermediate_images=PIXEL_INTERMEDIATES,
                     depth_channels=1, cond_channels="rgb+raw", rgb_images=rgb, sim_disp=raw,
                     generator=torch.Generator(device="cuda").manual_seed(7))
        return run

    run = run_of(pipe)
    t0 = time.perf_counter()
    out = run()
    _sync()
    print(f"pixel: first call {time.perf_counter() - t0:.2f}s", flush=True)
    counts, ms_bf16, peak_bf16 = _pixel_timed_calls(pipe, run, "pixel bf16")
    _check_counts("pixel bf16", counts, {})  # head dim 8, no transformer: no hand kernel
    wall, busy = profile_phase(run, "pixel bf16")
    ssi = _pixel_ssi_check(out, disp, mask)

    # one bf16 forward against the same weights in fp32 (TF32 off)
    x = torch.randn((BATCH, PIXEL_H, PIXEL_W, pipe.unet.in_channels), generator=gen,
                    device="cuda")
    fp32 = copy.deepcopy(pipe.unet).float()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with torch.no_grad():
        half = pipe.unet(x, 60)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            full = fp32(x, 60)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del fp32
    rel_bf16 = ((half - full).abs().max() / full.abs().max()).item()
    print(f"pixel unet forward: bf16 vs fp32 weights max err / max |out| = {rel_bf16:.3e} "
          f"(tol {PIXEL_BF16_REL_TOL})", flush=True)
    if not rel_bf16 <= PIXEL_BF16_REL_TOL:
        raise AssertionError(f"pixel UNet bf16 forward differs from fp32: {rel_bf16}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    # the fused GroupNorm alone, in bf16: one UNet2D forward through the
    # kernel against its plain version (no int8 on either side)
    g = copy.deepcopy(pipe).fuse_norms()
    with torch.no_grad():
        _zero_launches()
        fused = g.unet(x, 60)
        gn_counts = _int8_launches()
        r_gn = rel(fused, _plain_int8_forward(lambda: g.unet(x, 60)))
    del g
    print(f"pixel unet forward (bf16, fuse_norms only): {gn_counts['groupnorm_silu']} fused "
          f"GroupNorm launches; kernel vs plain max err / max |out| = {r_gn:.3e} (tol "
          f"{UNET_REL_TOL})", flush=True)
    if not (gn_counts["groupnorm_silu"] > 0 and r_gn <= UNET_REL_TOL):
        raise AssertionError(f"pixel bf16 fused-norm forward differs from the plain version: "
                             f"{r_gn}, {gn_counts}")

    # the pipeline's own int8 and fused-norm switches, on a copy
    q = copy.deepcopy(pipe).quantize_int8().fuse_norms()
    run_q = run_of(q)
    t0 = time.perf_counter()
    visits, table, gn_sites = _pixel_dry_pass(q, run_q)
    print(f"pixel int8+gn: routing dry pass (first call, {time.perf_counter() - t0:.2f}s): "
          f"{visits}", flush=True)
    for site, route in sorted(table.items(), key=str):
        print(f"  route {site}: {route}", flush=True)
    # the fused GroupNorm against its plain version at every site it takes;
    # its one device op a call is counted at groupnorm_cases' shapes only:
    # after the pixel calls' profiles torch.profiler has missed launches at
    # these sites (0.9 and 0.1 a call counted on an H100, the outputs right),
    # and the call's launch counts below must match the dry pass.
    print(f"pixel fused GroupNorm at the {len(gn_sites)} sites the gate admits (tol "
          f"{REL_TOL} x max |ref|):", flush=True)
    gen_gn = torch.Generator(device="cuda").manual_seed(5679)
    for shape, dtype, groups, pdt in sorted(gn_sites):
        _gn_case(shape, gen_gn, False, dtype, groups, pdt, count_ops=False)
    expected = {"conv2d_int8_dynamic": visits["conv"] + visits["dense"],
                "groupnorm_silu": visits["groupnorm_silu"]}
    if min(expected.values()) <= 0:
        raise AssertionError(f"pixel int8+gn: expected launches {expected}")
    counts_q, ms_q, peak_q = _pixel_timed_calls(q, run_q, "pixel int8+gn")
    _check_counts("pixel int8+gn", counts_q, expected)
    wall_q, busy_q = profile_phase(run_q, "pixel int8+gn")

    def forward():
        with torch.no_grad():
            return q.unet(x, 60)

    fast = forward()
    r_conv = rel(fast, _plain_int8_forward(forward, attention=False))
    r_all = rel(fast, _plain_int8_forward(forward))
    print(f"pixel unet forward (int8+gn), max err / max |out|: kernels vs the conv's plain "
          f"version (bit-equal) {r_conv:.3e} (tol 1e-3); all plain {r_all:.3e} (tol "
          f"{UNET_REL_TOL})", flush=True)
    if not (r_conv <= 1e-3 and r_all <= UNET_REL_TOL):
        raise AssertionError(f"pixel int8+gn forward differs from the plain versions: "
                             f"{r_conv}, {r_all}")
    del q
    _sync()
    return {"bf16": {"ms_per_frame": ms_bf16, "peak_bytes": peak_bf16, "wall_ms": wall,
                     "busy_ms": busy},
            "int8_gn": {"ms_per_frame": ms_q, "peak_bytes": peak_q, "wall_ms": wall_q,
                        "busy_ms": busy_q, "launches": {k: v for k, v in counts_q.items() if v}},
            "bf16_vs_fp32": rel_bf16, "fused_norm_vs_plain": r_gn,
            "int8_gn_vs_plain": r_all, "ssi_denormalize_err": ssi}


_KERNEL_GROUPS = (
    # the port's own kernels first, so that no library group takes one of them
    ("winograd kernels (input transform, tap GEMMs, split sum)", ("wino_",)),
    ("group_norm_silu kernel (one launch on clusters)", ("gn_silu_cluster_kernel",)),
    ("attention_fused_int8 kernels (QKV projection, quantize)",
     ("qkv_int8_kernel", "quantize_qkv_kernel")),
    ("fused attention output projection (int8 and bf16 bodies)", ("out_proj_kernel",)),
    ("conv2d_bf16 kernels (the bf16 fused attention's QKV projection; split sum)",
     ("conv_bf16_sm90_kernel", "conv_bf16_reduce_kernel")),
    ("conv2d_int8 kernels (xla epilogue; split sum)",
     ("conv_int8_sm90_kernel<0", "conv_int8_reduce_kernel<0")),
    ("conv2d_int8 kernels (tpu epilogue; split sum)",
     ("conv_int8_sm90_kernel<1", "conv_int8_reduce_kernel<1")),
    ("conv2d_int8 kernels (halo epilogue; split sum)",
     ("conv_int8_sm90_kernel<2", "conv_int8_reduce_kernel<2")),
    ("geglu_ff_int8 kernels (table clear, absmax, requantize, output, split sum)",
     ("geglu_int8_",)),
    # the rows kernel is also the fused attention's core (head width 64)
    ("int8 whole-row attention kernels (mha_attention_int8; the fused attention's core)",
     ("mha_int8_rows_kernel", "mha_int8_wide_kernel", "absmax_kernel",
      "quantize_heads_kernel")),
    ("dynamic int8 absmax slots (convolutions' batch items)", ("absmax_slots_kernel",)),
    ("dynamic int8 groups quantize (3x3 stride-1 convolutions)", ("act_quantize_groups_kernel",)),
    ("dynamic int8 row quantize (dense layers)", ("row_quantize_kernel",)),
    ("dynamic int8 small dense (one launch)", ("dense_small_int8_kernel",)),
    ("conv2d_int8 loader-quantize kernels (dynamic 1x1 and stride 2)",
     ("conv_int8_loadq_sm90_kernel",)),
    ("quantize_int8 kernel (standalone and in the int8 ops' entry points)",
     ("act_quantize_kernel",)),
    ("geglu_ff kernels (gate, output, split sum)", ("geglu_bf16_",)),
    ("mha_attention kernel (bf16; the bf16 fused attention's core)", ("mha_kernel",)),
    ("convolution", ("conv", "cudnn", "xmma_fprop", "implicit_gemm", "nhwc", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "splitk")),
    ("normalization and softmax", ("norm", "softmax", "reduce")),
)


def _group(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in _KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise and other"


def profile_phase(run, label: str = "pipeline"):
    """One more pipeline call under torch.profiler: device time by kernel
    group and the device's idle share of the call's wall time. Returns
    (wall ms, device busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us <= 0 or getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us / 1e3, evt.count, evt.key))
        g = _group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    busy = sum(groups.values())
    print(f"profile ({label}): one call {wall_ms:.1f} ms wall (profiled), device busy {busy:.1f} ms "
          f"= {busy / BATCH:.1f} ms/frame, idle share {max(0.0, 1 - busy / wall_ms):.3f}",
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.2f} ms ({ms / max(busy, 1e-9):.3f})", flush=True)
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"  top: {ms:8.2f} ms  x{count:<5d} {name[:110]}", flush=True)
    return wall_ms, busy


def _kernel_entry(name, source, replaces, rows, launches, note=None):
    first = rows[0]
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": first["ms"], "kernel_ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "library_call": first["library_call"],
        "shapes": rows,
    }
    if note:
        entry["launches_note"] = note
    return entry


def main() -> int:
    pin_one_card()
    card = device_phase()
    build_phase()
    if sys.argv[1:] == ["--geglu"]:
        import torch

        gen = torch.Generator(device="cuda").manual_seed(1234)
        geglu_cases(gen)
        geglu_int8_cases(gen)
        _sync()
        print("GEGLU cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--conv"]:
        import torch

        conv_int8_cases(torch.Generator(device="cuda").manual_seed(4321))
        conv_and_fused_bf16_kernel_phase()
        print("conv cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--winograd"]:
        import torch

        winograd_cases(torch.Generator(device="cuda").manual_seed(5678))
        _sync()
        print("Winograd cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--dynamic"]:
        import torch

        dynamic_int8_cases(torch.Generator(device="cuda").manual_seed(2468))
        print("dynamic int8 cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--quant"]:
        import torch

        gen = torch.Generator(device="cuda").manual_seed(4321)
        _quantize_case((BATCH, 3600, 320), gen, True)
        for shape in ((7,), (3, 5, 33), (1, 1, 4103)):
            _quantize_case(shape, gen, False)
        pdl_race_cases(gen)
        tma_map_host_cost()
        print("quantize and back-to-back cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--groupnorm"]:
        import torch

        groupnorm_cases(torch.Generator(device="cuda").manual_seed(5678))
        print("GroupNorm cases passed", flush=True)
        return 0
    if sys.argv[1:] == ["--pixel"]:
        pixel = pixel_phase()
        print(json.dumps({"pixel": pixel, "torch_bench_pixel": bench_phase(pixel_only=True)}),
              flush=True)
        print("pixel phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--attention"]:
        import torch

        attention_bf16_cases(torch.Generator(device="cuda").manual_seed(1234))
        attention_fused_bf16_cases(torch.Generator(device="cuda").manual_seed(8765))
        gen = torch.Generator(device="cuda").manual_seed(4321)
        attention_int8_cases(gen)
        attention_fused_int8_cases(gen)
        _sync()
        print("attention cases passed", flush=True)
        return 0
    attn_rows, geglu_rows = kernel_phase()
    int8_rows = int8_kernel_phase()
    opt_rows = opt_in_kernel_phase()
    new_rows = conv_and_fused_bf16_kernel_phase()
    pipe, inputs, counts, ms_per_frame = pipeline_phase()
    fused_counts, fused_ms_per_frame = latency_fused_phase(pipe, inputs)
    bench_counts, bench_ms_per_frame, bench_expected, visits = bench_default_phase(pipe, inputs)
    routes = conv_routes_phase(pipe, inputs, bench_expected)
    dynamic = dynamic_paths_phase(pipe, inputs, visits)
    vae8_counts, vae8_ms_per_frame = vae8_phase(pipe, inputs)
    opt_counts, opt_ms_per_frame = opt_in_phase(pipe, inputs)

    import torch

    del pipe, inputs
    torch.cuda.empty_cache()
    pixel = pixel_phase()
    torch.cuda.empty_cache()  # the bench's own process builds its own models
    bench_lines = bench_phase()

    kernels = [
        _kernel_entry("mha_attention", "d3roma_tpu_torch/csrc/attention.cu",
                      "d3roma_tpu/ops/pallas/attention.py:69", attn_rows,
                      counts["attention"]),
        _kernel_entry("geglu_ff", "d3roma_tpu_torch/csrc/geglu.cu",
                      "d3roma_tpu/ops/pallas/geglu.py:114", geglu_rows, counts["geglu"]),
        _kernel_entry("mha_attention_int8", "d3roma_tpu_torch/csrc/attention_int8.cu",
                      "d3roma_tpu/ops/pallas/attention.py:90", int8_rows["attention_int8"],
                      bench_counts["attention_int8"]),
        _kernel_entry("geglu_ff_int8", "d3roma_tpu_torch/csrc/geglu_int8.cu",
                      "d3roma_tpu/ops/pallas/geglu.py:71", int8_rows["geglu_int8"],
                      bench_counts["geglu_int8"]),
        dict(_kernel_entry("conv2d_int8", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                           "d3roma_tpu/ops/pallas/conv2d.py:80", int8_rows["conv2d_int8"],
                           bench_counts["conv2d_int8"]),
             tma_map_host_cost=new_rows["tma_map_host_cost"]),
        # no Pallas kernel: the XLA int8 conv and dot of the dynamic modes
        dict(_kernel_entry("conv2d_int8_dynamic", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                           "d3roma_tpu/ops/quant.py:370", int8_rows["conv2d_int8_dynamic"],
                           dynamic["all"][0]["conv2d_int8_dynamic"],
                           f"the \"all\" path; {dynamic['dense'][0]['conv2d_int8_dynamic']} on "
                           f"\"dense\""),
             back_to_back=int8_rows["back_to_back_dynamic"],
             batch16_dense=int8_rows["conv2d_int8_dynamic_b16"],
             pixel_launches=pixel["int8_gn"]["launches"]["conv2d_int8_dynamic"]),
        # no Pallas kernel: the XLA quantization in front of the int8 ops
        _kernel_entry("quantize_int8", "d3roma_tpu_torch/csrc/quantize.cu",
                      "d3roma_tpu/ops/quant.py:64", int8_rows["quantize"],
                      bench_counts["quantize"]),
        dict(_kernel_entry("groupnorm_silu", "d3roma_tpu_torch/csrc/groupnorm_silu.cu",
                           "d3roma_tpu/ops/pallas/groupnorm.py:58", opt_rows["groupnorm_silu"],
                           opt_counts["groupnorm_silu"]),
             pixel_launches=pixel["int8_gn"]["launches"]["groupnorm_silu"]),
        _kernel_entry("attention_fused_int8", "d3roma_tpu_torch/csrc/attention_fused_int8.cu",
                      "d3roma_tpu/ops/pallas/attention_fused.py:80",
                      opt_rows["attention_fused_int8"], opt_counts["attention_fused_int8"]),
        _kernel_entry("winograd_fused", "d3roma_tpu_torch/csrc/winograd_fused.cu",
                      "d3roma_tpu/ops/pallas/winograd_fused.py:147", opt_rows["winograd"],
                      opt_counts["winograd"],
                      f"the opt-in path; {dynamic['wino'][0]['winograd']} on \"wino\""),
        _kernel_entry("attention_fused_bf16", "d3roma_tpu_torch/csrc/attention_fused_bf16.cu",
                      "d3roma_tpu/ops/pallas/attention_fused.py:145",
                      new_rows["attention_fused_bf16"], fused_counts["attention_fused_bf16"]),
        # conv3x3_flat's and conv3x3_halo's bf16 bodies: no path of the port
        # calls them (the fused attention's projection uses the kernel
        # inside its own launch)
        _kernel_entry("conv2d_bf16", "d3roma_tpu_torch/csrc/conv2d_bf16.cu",
                      "d3roma_tpu/ops/pallas/conv2d.py:103", new_rows["conv2d_bf16"],
                      fused_counts["conv2d_bf16"], "kernel phase only"),
        _kernel_entry("conv3x3_flat_int8 (tpu epilogue)", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                      "d3roma_tpu/ops/pallas/conv2d.py:80", new_rows["conv3x3_flat_tpu"],
                      routes["mxu"][0]["conv2d_int8_tpu"]),
        _kernel_entry("conv3x3_rowtap (tpu epilogue)", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                      "d3roma_tpu/ops/pallas/conv2d.py:215", new_rows["conv3x3_rowtap"], 0,
                      "kernel phase only"),
        _kernel_entry("conv3x3_halo (halo epilogue)", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                      "d3roma_tpu/ops/pallas/conv2d_halo.py:92", new_rows["conv3x3_halo"],
                      routes["halo"][0]["conv2d_int8_halo"]),
    ]
    # the card again, so that the end of a long log still names it
    print(card, flush=True)
    print(json.dumps({"pipeline_ms_per_frame": {"latency": ms_per_frame,
                                                "latency_fused": fused_ms_per_frame,
                                                "bench_default": bench_ms_per_frame,
                                                "halo": routes["halo"][1],
                                                "mxu": routes["mxu"][1],
                                                **{k: v[1] for k, v in dynamic.items()},
                                                "vae8": vae8_ms_per_frame,
                                                "opt_in": opt_ms_per_frame},
                      "launches_per_call": {k: {n: c for n, c in v[0].items() if c}
                                            for k, v in dynamic.items()},
                      "batch": BATCH, "steps": STEPS}), flush=True)
    print(json.dumps({"pixel": pixel}), flush=True)
    print(json.dumps({"torch_bench": bench_lines}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
