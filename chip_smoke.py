#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA GPU and nvcc (the
kernels build from d3roma_tpu_torch/csrc/ at first use). Phases, each
failing the run on its own error:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the kernels, one nvcc per source, all at once;
3. kernels: each hand-written kernel against its plain PyTorch version
   (computed in fp32) at the flagship shapes and a few ragged ones, with the
   stated tolerance; time kernel, plain version and one library call;
4. pipeline: GuidedLatentDiffusionPipeline.fast_inference("latency") at the
   full SD2.1 geometry (random seeded weights held in bf16), batch 2,
   RGB + raw at 640x360, 10 DDIM steps; the launch counts of one call must
   be 100 attention and 160 GEGLU; ms/frame is the median of three calls;
   one more call is profiled (device time by kernel group, idle share); one
   UNet forward with the kernels must agree with the same forward through
   the plain torch paths;
5. a JSON line of per-kernel numbers, then the JSON result as the last line.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
# Kernels against their plain versions: max |err| <= REL_TOL * max |ref|.
# bf16 rounding of the output (2^-9 relative) and of P or of the gated
# product keeps the measured ratio near 4e-3 for both kernels; an error of a
# few percent anywhere (a denominator, a rescale, a bias) exceeds it.
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


def bound(flops: float, nbytes: float):
    """Least time on the card (ms) and what sets it."""
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pin_one_card() -> None:
    """Make the script see exactly one card, the first of those visible."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]


def device_phase() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if torch.cuda.device_count() != 1:
        raise SystemExit(f"chip_smoke: {torch.cuda.device_count()} cards visible, want 1")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)


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
                if "registers" in ln or "spill" in ln:
                    print(f"  ptxas {name}: {ln.strip()}", flush=True)


def _attention_case(b, n, m, h, d, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import mha_attention, mha_attention_plain

    q, k, v = (torch.randn((b, length, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for length in (n, m, m))
    out = mha_attention(q, k, v)
    ref = mha_attention_plain(q.float(), k.float(), v.float())
    _sync()
    err = (out.float() - ref).abs().max().item()
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [b, n, m, h, d], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item()}
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["ms"] = time_ms(lambda: mha_attention(q, k, v))
        row["plain_ms"] = time_ms(lambda: mha_attention_plain(q, k, v), reps=5)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * b * h * n * m * d
        nbytes = 2.0 * (2 * b * n * h * d + 2 * b * m * h * d)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    _sync()
    print(f"  attention {row}", flush=True)
    if not err <= tol:
        raise AssertionError(f"attention {row['shape']}: max abs err {err} > {tol}")
    return row


def _geglu_case(rows, c, f, gen, timed):
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import geglu
    from d3roma_tpu_torch.ops.kernels import geglu_ff, geglu_ff_plain

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = rnd(1, rows, c).to(torch.bfloat16)
    w1h, w1g = (rnd(c, f, scale=c ** -0.5).to(torch.bfloat16) for _ in range(2))
    w2 = rnd(f, c, scale=f ** -0.5).to(torch.bfloat16)
    b1h, b1g, b2 = rnd(f, scale=0.1), rnd(f, scale=0.1), rnd(c, scale=0.1)
    out = geglu_ff(x, w1h, w1g, w2, b1h, b1g, b2)
    ref = geglu_ff_plain(x.float(), w1h.float(), w1g.float(), w2.float(), b1h, b1g, b2)
    _sync()
    err = (out.float() - ref).abs().max().item()
    cb = geglu._output_chunk(c)
    tol = REL_TOL * ref.abs().max().item()
    row = {"shape": [rows, c, f], "max_abs_err": err, "tol": tol,
           "max_abs_out": ref.abs().max().item(), "column_chunk": cb,
           "hidden_splits": geglu._hidden_splits(rows, c, f, cb, x.device.index)}
    if timed:
        w1 = torch.cat([w1h, w1g], dim=1).t().contiguous()
        b1 = torch.cat([b1h, b1g]).to(torch.bfloat16)
        w2t = w2.t().contiguous()
        b2l = b2.to(torch.bfloat16)

        def library():
            hh, gg = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(hh * F.gelu(gg, approximate="tanh"), w2t, b2l)

        row["ms"] = time_ms(lambda: geglu_ff(x, w1h, w1g, w2, b1h, b1g, b2))
        row["plain_ms"] = time_ms(lambda: geglu_ff_plain(x, w1h, w1g, w2, b1h, b1g, b2),
                                  reps=5)
        row["library_ms"] = time_ms(library)
        flops = 6.0 * rows * c * f
        nbytes = 2.0 * (2 * rows * c + 3 * c * f) + 4.0 * (2 * f + c)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    _sync()
    print(f"  geglu {row}", flush=True)
    if not err <= tol:
        raise AssertionError(f"geglu {row['shape']}: max abs err {err} > {tol}")
    return row


def kernel_phase():
    """Each kernel against its plain version: the flagship shapes (timed) and
    ragged ones that exercise the masked edges (checked only)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1234)
    attn = [_attention_case(BATCH, 3600, 3600, 5, 64, gen, True),
            _attention_case(BATCH, 920, 920, 10, 64, gen, True)]
    for shape in ((1, 600, 600, 2, 64), (2, 300, 77, 3, 32), (1, 100, 130, 2, 128),
                  (1, 70, 50, 1, 48)):
        _attention_case(*shape, gen, False)
    geglu = [_geglu_case(BATCH * 3600, 320, 1280, gen, True),
             _geglu_case(BATCH * 920, 640, 2560, gen, True),
             _geglu_case(BATCH * 240, 1280, 5120, gen, True),
             _geglu_case(BATCH * 60, 1280, 5120, gen, True)]
    for shape in ((100, 64, 256), (33, 1280, 5120), (7, 32, 128), (50, 1920, 7680)):
        _geglu_case(*shape, gen, False)
    _sync()
    return attn, geglu


def _schedule():
    from d3roma_tpu_torch.ops.schedules import ScheduleConfig

    return ScheduleConfig(
        num_train_timesteps=1000, beta_schedule="scaled_linear",
        beta_start=0.00085, beta_end=0.012, prediction_type="v_prediction",
        clip_sample=False, timestep_spacing="leading", steps_offset=1)


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
    from d3roma_tpu_torch.ops.kernels import geglu_ff, mha_attention
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

    def run():
        return pipe(num_inference_steps=STEPS, num_intermediate_images=1,
                    cond_channels="rgb+raw", rgb_images=rgb, sim_disp=raw,
                    generator=torch.Generator(device="cuda").manual_seed(7))

    t0 = time.perf_counter()
    run()
    _sync()
    print(f"pipeline: first call {time.perf_counter() - t0:.2f}s", flush=True)

    mha_attention.launches = 0
    geglu_ff.launches = 0
    t0 = time.perf_counter()
    out = run()
    _sync()
    seconds = time.perf_counter() - t0
    counts = {"attention": mha_attention.launches, "geglu": geglu_ff.launches}
    # two more calls: the host's share of a call varies from machine to
    # machine, so the median of three is the number kept
    walls = [seconds]
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        _sync()
        walls.append(time.perf_counter() - t0)
    ms_per_frame = sorted(walls)[1] * 1e3 / BATCH
    disp = pipe.normalizer.denormalize(out.images.float())
    print(f"pipeline: {counts} launches in one call; {ms_per_frame:.2f} ms/frame, median "
          f"of {[round(w * 1e3 / BATCH, 2) for w in walls]} "
          f"(batch {BATCH}, {STEPS} steps, {H}x{W}); images {tuple(out.images.shape)} "
          f"in [{out.images.min().item():.4f}, {out.images.max().item():.4f}], "
          f"disparity in [{disp.min().item():.3f}, {disp.max().item():.3f}]", flush=True)
    if tuple(out.images.shape) != (BATCH, H, W, 1):
        raise AssertionError(f"images shape {tuple(out.images.shape)}")
    if not (torch.isfinite(out.images).all() and torch.isfinite(disp).all()):
        raise AssertionError("non-finite pipeline output")
    if counts != {"attention": 10 * STEPS, "geglu": 16 * STEPS}:
        raise AssertionError(f"kernel launches {counts}, expected "
                             f"{{'attention': {10 * STEPS}, 'geglu': {16 * STEPS}}}")

    profile_phase(run)

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
    return counts, ms_per_frame


_KERNEL_GROUPS = (
    ("geglu_ff kernel", ("geglu_",)),
    ("mha_attention kernel", ("mha_kernel",)),
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


def profile_phase(run) -> None:
    """One more pipeline call under torch.profiler: device time by kernel
    group and the device's idle share of the call's wall time."""
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
    print(f"profile: one call {wall_ms:.1f} ms wall (profiled), device busy {busy:.1f} ms "
          f"= {busy / BATCH:.1f} ms/frame, idle share {max(0.0, 1 - busy / wall_ms):.3f}",
          flush=True)
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {ms:.2f} ms ({ms / max(busy, 1e-9):.3f})", flush=True)
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"  top: {ms:8.2f} ms  x{count:<5d} {name[:110]}", flush=True)


def _kernel_entry(name, source, replaces, rows, launches):
    first = rows[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": first["ms"], "kernel_ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"], "shapes": rows,
    }


def main() -> int:
    pin_one_card()
    device_phase()
    build_phase()
    attn_rows, geglu_rows = kernel_phase()
    counts, ms_per_frame = pipeline_phase()

    import torch

    kernels = [
        _kernel_entry("mha_attention", "d3roma_tpu_torch/csrc/attention.cu",
                      "d3roma_tpu/ops/pallas/attention.py:69", attn_rows,
                      counts["attention"]),
        _kernel_entry("geglu_ff", "d3roma_tpu_torch/csrc/geglu.cu",
                      "d3roma_tpu/ops/pallas/geglu.py:114", geglu_rows, counts["geglu"]),
    ]
    print(json.dumps({"pipeline_ms_per_frame": ms_per_frame, "batch": BATCH,
                      "steps": STEPS}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
