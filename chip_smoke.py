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
    python3 chip_smoke.py --eval     # device, build and the evaluation phase only
    python3 chip_smoke.py --train    # device, build and the training phase only
    python3 chip_smoke.py --train-parallel  # device, build, the train frames, the one-process
                                     # first epoch and the DP2 and TP2 torchruns beside it
    python3 chip_smoke.py --train-tp-ff  # device, build and TP2's feed-forward on chunks
                                     # against its gathered projection (two runs)
    python3 chip_smoke.py --accuracy # device, build, one bf16 epoch and the accuracy phase
    python3 chip_smoke.py --serve    # device, build and the serving phase only
    python3 chip_smoke.py --import   # device, build and the reference-import phase only
    python3 chip_smoke.py --offline  # device, build and the offline-tooling phase only
    python3 chip_smoke.py --tp       # device, build and the tensor-parallel phase only
    python3 chip_smoke.py --mono     # device, build and the mono-datasets phase only
    python3 chip_smoke.py --synthetic  # device, build and the synthetic-data phase only

Run from the repository root, on a machine with a CUDA GPU and nvcc (the
kernels build from d3roma_tpu_torch/csrc/ at first use). Phases, each
failing the run on its own error:

1. device: require CUDA; print the card's name and power limit, and its
   maximum SM clock (the exponentials' bound of the attention rows);
2. build: compile the kernels, one nvcc per source, all at once, and the
   native EXR reader (`csrc/d3roma_io.cpp`, g++);
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
   must be 100 attention and 160 GEGLU; ms/frame is the faster of two
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
    no hand kernel launched (head dim 8, no transformer), ms/frame (the
    faster of two calls), peak memory, the profile; SSI denormalize (least
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
12. evaluation (`eval_phase`): a full-width latent pipeline saved with
    save_pretrained, 4 procedural HISS frames, `python -m
    d3roma_tpu_torch.evaluate task=eval_ldm_mixed_rgb+raw ...
    task.fast_inference=latency` in its own process (finite metrics, every
    artifact read back), evaluate_dataset in process through the kernels
    (their launch counts: 5 attention sites and 16 GEGLU blocks a UNet
    pass at 272x480) and through their plain versions (each batch's
    prediction within EVAL_PRED_REL_TOL, the metrics within
    EVAL_METRIC_REL_TOL, other noise outside EVAL_PRED_REL_TOL), eval
    ms/frame and the loader's host ms/frame, `distributed_evaluate` data
    parallel on two ranks (torchrun, gloo) against the entry point's metrics
    (depth/rel, disp/epe within EVAL_METRIC_REL_TOL),
    and the golden stages (dumped through the plain versions, compared
    through the kernels);
13. training (`train_phase`): 24 procedural HISS frames and 24 SceneFlow
    frames at 960x540 in a temporary tree; `python -m
    d3roma_tpu_torch.train task=train_ldm_mixed_rgb+raw ...` in its own
    process for one epoch (3 steps of batch 16 at 180x320, full SD2.1
    width, fp32, AdamW, with the in-training eval and the best/ and epoch
    exports): every logged loss and grad_norm finite, the checkpoint (with
    AdamW's moments) and exports written, the epoch export loaded and
    called; then resumed to a second epoch (global step 3 to 6) in bf16
    compute over the fp32 parameters (task.mixed_precision=bf16), with its
    in-training eval: its losses finite, state.pt and the epoch_0001/
    export fp32, the export's UNet equal to the checkpoint's parameters;
    one fp32 step of a narrow latent model on
    the card against the CPU from the same weights and draws, the card's
    under set_sync_debug_mode("error"); the full-width step's ms/step,
    samples/s, peak memory and one profiled step (idle share, device ms by
    phase and by kernel class), with no hand-written kernel launched (the
    training path reaches none of the JAX package's Pallas kernels);
    beside them (`TrainParallel`), `python -m torch.distributed.run
    --standalone --nproc-per-node 2` of the same entry point and arguments,
    both ranks on the card over gloo: TP2 (task.tensor_parallel=2, one
    step), started with the frames before the eval phase (its loss held to
    the first epoch's step 1, its gathered state, loaded in the first
    epoch's process, to that run's step 1; both ranks shard parameters and
    moments), then DP2 beside the first epoch and the resumed run (its
    losses, grad_norms, step-3 parameters and AdamW moments and eval
    metrics held to the first epoch's; rank 1 wrote nothing): ms/step, peak
    memory, a rank's parameter and optimizer bytes, collectives a step;
    joined (`train_parallel_join`) after the accuracy phase, before the
    timed step (`train_timing`), which runs alone;
14. accuracy (`accuracy_phase`): the full-width step in bf16 compute
    beside the fp32 one (ms/step, samples/s, peak memory, idle share, no
    hand kernel); `d3roma_tpu_torch.deepcache_accuracy` in process on the
    training phase's bf16 checkpoint (alone, `--accuracy`, on one bf16
    epoch of the train entry point from random weights): 8 procedural val
    frames at batch 4, the rows bf16:1, bf16:2d2, int8:1, int8:2d2, each
    on its own copy of the loaded pipeline; the table with its drift
    columns, every metric finite; the int8 rows' launches a call of the int8
    attention, GEGLU, conv and quantize kernels; the int8:1 row's first
    batch of predictions through the kernels bit-equal to the same batch
    through the conv, GEGLU and quantize kernels' plain versions, and
    within twice the int8 noise (the plain int8 batch against the bf16:1
    row's) of the same batch through every plain version, the plain batch
    on other noise outside it;
15. mono datasets (`mono_phase`): every committed fixture of
    tests/data/torch_mono/ (JPEGs and HDF5 files PIL and h5py wrote)
    decoded by the port's host readers, each array's sha256 the manifest's,
    the decode ms of an item; `python -m d3roma_tpu_torch.train
    task=train_ldm_mono` in its own process (with timing hooks) on trees of
    symlinks to the fixtures (8 NYUv2 and 8 HyperSim items, each set
    weighted 2: two steps of batch 16 at 180x320 in one epoch, full SD2.1
    width, fp32), its losses finite, the in-training eval at step 2 on one
    batch of 4 NYUv2 test frames, best/ exported; ms/step, the loader's host
    ms an item, peak memory, idle share; then `python -m
    d3roma_tpu_torch.evaluate task=eval_ldm_mono` on best/ (4 frames,
    my_ddim at 3 steps): finite metrics, the prediction files written;
16. synthetic data (`synthetic_phase`): `python -m
    d3roma_tpu_torch.render_synthetic` on conf/synthetic/hssd.yaml (640x360,
    backend auto, which falls back to the procedural SimBackend) in three
    processes side by side, 16 train, 4 val and 4 test frames at a pinned
    seed; `python -m d3roma_tpu_torch.stereo_matching` on the tree, every
    pair's sim depth finite and valid on at least SYN_VALID_MIN of the
    frame; `python -m d3roma_tpu_torch.train task=train_hiss` in its own
    process (timing hooks) at the preset's widths, left+right+raw, 256x320,
    batch 32, fp32, three steps in one epoch: losses finite, the in-training
    eval at step 3, checkpoint and best/ written, ms/step, samples/s, peak
    memory, idle share, the first step's seconds, the loader's host ms an
    item, no hand kernel launched; beside it one fp32 step of a narrow
    pixel model on the card against the CPU under
    set_sync_debug_mode("error"), and `python -m d3roma_tpu_torch.camera_test
    --replay assets/examples`; then `python -m d3roma_tpu_torch.evaluate
    task=eval_his_sim task.plot_intermediate_metrics=true` on best/ (4 test
    frames, my_ddpm 8 steps): finite metrics, every artifact read back with
    the intermediate-metrics figure, no hand kernel launched, ms/frame;
17. serving (`serve_phase`): a full-width rgb+raw pipeline saved, and a
    copy calibrated by `python -m d3roma_tpu_torch.calibrate_pipeline` in
    its own process (4 procedural frames at 360x640, 10 steps); `python -m
    d3roma_tpu_torch.demo` in its own process (its four artifacts read
    back); the startup probe picking "latency" first; `python -m
    d3roma_tpu_torch.serve --port 0 --max-batch 4` on the calibrated
    directory under SSI: ready after its warm frame, 8 concurrent requests
    (two at 480x848) each answered at its own frame's depth scale, a
    malformed one 400, /metrics, SIGTERM; in process, D3RoMa's batched call
    under throughput (launch counts from the calibrated tables, bit-equal to
    the bit-equal kernels' plain versions, within twice the int8 noise of
    every plain version, no host synchronization from upload to copy) and its
    single-frame rgb+raw and left+right+raw calls under latency; ms/request,
    ms/frame, host ms, idle share, the server's p50/p90/p99;
18. offline tooling (`offline_phase`): the NCC block matcher at 360x640,
    batch 4, D 101 against the CPU (TF32 shown not to reach it), its
    ms/frame, peak memory, StepTimer summary and a profiling.trace file;
    `python -m d3roma_tpu_torch.stereo_matching` on 8 frames in its own
    process, its EXRs bit-equal through the native and the Python reader,
    their decode ms; `reproject_depth` at 1280x720 against the CPU; one
    guided evaluate_dataset batch under guide_source="stereo-match"
    (left+right+raw at full width, latency), its target against the CPU
    matcher; the serve phase's calibrate_pipeline run (alone, `--offline`
    runs its own);
19. reference checkpoints and guidance (`import_phase`): a bare SD2.1
    diffusers directory at full width (random seeded weights: the UNet in
    fp16 safetensors, the VAE in fp32 .bin, the 23-layer text tower in fp32
    safetensors) imported by `python -m d3roma_tpu_torch.import_reference
    --cond-channels rgb+raw` in its own process (timed; every tensor equal
    to its source, conv_in the fp32 widening bit for bit, the text
    embedding within 1e-4 of the CPU forward); `python -m
    d3roma_tpu_torch.parity_check` at 64x96 and its golden dump and
    compare; the imported pipeline under latency at batch 1, 360x640, 3
    steps, unguided and guided (10 Adam steps at lr 1e-3): 30 attention
    and 48 GEGLU launches each, the guided images within
    IMPORT_PRED_REL_TOL of the plain versions' and different from the
    unguided ones, ms/request and the guided peak memory; under
    throughput, calibrated, 2 steps: guided bit-equal to unguided, the
    extra launches those of 20 decodes;
20. tensor parallelism (`tp_phase`): two ranks on the card under torchrun
    (gloo): `mha_attention_tp` and `geglu_ff_tp` at the flagship batch-1
    shapes against their plain compositions, timed (kernel and collective
    apart); `D3RoMa` rgb+raw at full width, batch 1, 360x640, TP_STEPS (1)
    steps under task.tensor_parallel=2, latency and throughput (calibrated
    on the meshed pipeline): the launch counts (10 / 16 through the
    compositions; 12 / 16 in int8), the depth against the tp=1 call and
    the plain compositions', ms/request and its collectives, a rank's
    parameter bytes (`--tp` alone also runs the eval phase's DP2 check);
21. the torch bench, `python -m d3roma_tpu_torch.bench`, in its own process
    at batch 2 with 2 timed calls (records and scales in a temporary
    directory), at the default setting, at BENCH_CLIP_PCT=0.999 and at
    BENCH_MODEL=pixel: its JSON line must carry every key of the JAX
    bench's at that setting, value > 0;
22. a JSON line of per-kernel numbers, then the JSON result as the last line.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
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

    if torch.cuda.is_available():
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
    from d3roma_tpu_torch.utils import native_io

    t0 = time.perf_counter()
    secs = _build.build(KERNEL_SOURCES)
    print(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"wall {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    lib = native_io.build()  # host code (g++): the EXR reader; raises if it does not build
    print(f"build: {lib.name} (g++) in {time.perf_counter() - t0:.1f}s", flush=True)
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


def _device_events(fn, calls: int, attempts: int = 12) -> dict:
    """One torch.profiler session of `calls` calls of fn, after a synchronize:
    {device op name (kernel, memset or copy): [count, self device us]}. Every
    caller's fn launches work on the card, so a session that records no device
    activity at all lost its events (on an H100 three sessions in a row came
    back empty for a dense whose sessions before and after counted both of
    its kernels); such a session is run again, up to `attempts` in all, and
    an empty result is returned only when every attempt was empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    events = {}
    for attempt in range(attempts):
        _sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            _sync()
        events = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != cuda:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            entry = events.setdefault(evt.key, [0, 0.0])
            entry[0] += evt.count
            entry[1] += us
        if events:
            break
        print(f"  torch.profiler recorded no device op in session {attempt + 1} of "
              f"{calls} calls: run again", flush=True)
    return events


def host_and_device_ms(fn, calls: int = 20):
    """Host time to issue one call of fn (the mean over `calls` issued right
    after a synchronize: too few for the launch queue to fill, so the device
    never holds the host back), device time of one call (its kernels' time
    summed by torch.profiler) and that time by device op (kernel or memset
    name -> ms a call)."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    _sync()
    _device_events(fn, calls)  # the first session of a process can miss early kernels
    split = {}
    for key, (_, us) in _device_events(fn, calls).items():
        if us > 0:
            split[key[:80]] = split.get(key[:80], 0.0) + us / calls / 1e3
    return host_ms, sum(split.values()), split


def device_ops_per_call(fn, calls: int = 10, sessions: int = 3) -> float:
    """Device operations (kernels, memsets, copies) one call of fn runs, as
    torch.profiler counts them over `calls` calls: the most of `sessions`
    sessions, since a session can miss a kernel (one of ten GroupNorm
    launches once went uncounted) but never counts one that did not run."""
    fn()
    _sync()
    return max(sum(n for n, _ in _device_events(fn, calls).values()) / calls
               for _ in range(sessions))


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
    (torch.profiler, the union over `sessions` sessions of two calls, and
    over up to as many more while it is short of the plan: a busy session
    can drop an event, never add one) must be the plan's count,
    with no memset; a dense at most 2 (3 with a split), 1 on the small
    route; a loader convolution at most 2 plus a split sum."""
    fn()
    _sync()
    names = set()
    # a session short of the plan's count is followed by more, up to twice
    # `sessions`: the union only grows towards what the calls ran
    for i in range(2 * sessions):
        if i >= sessions and len(names) >= plan.device_ops:
            break
        names |= set(_device_events(fn, 2))
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
    kept), then one more: the number kept is the faster of the two (two
    calls a path keep the whole pass inside its time limit). Checks the
    output's shape and that it and its disparity are finite. Returns
    (counts, ms/frame)."""
    import torch

    _zero_launches()
    t0 = time.perf_counter()
    out = run()
    _sync()
    walls = [time.perf_counter() - t0]
    counts = _int8_launches()
    t0 = time.perf_counter()
    run()
    _sync()
    walls.append(time.perf_counter() - t0)
    ms_per_frame = min(walls) * 1e3 / BATCH
    disp = pipe.normalizer.denormalize(out.images.float())
    print(f"{label}: {ms_per_frame:.2f} ms/frame, the faster of "
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
    2 timed calls, its records and calibrated scales in a temporary
    directory (one a run): at the default setting (static int8, 2d2,
    calibrated), with BENCH_CLIP_PCT=0.999 (quantile calibration, clipped
    scales) and with BENCH_MODEL=pixel (only this one with `pixel_only`),
    the three processes side by side (their fps, at batch 2 host-bound
    anyway, are not a lone run's). Each must exit 0 and print one JSON line
    with every key of the JAX bench's line at its setting (and act_clip_pct
    with the clipping), value > 0. Returns the lines."""
    import tempfile

    runs = (("default", {}), ("clip 0.999", {"BENCH_CLIP_PCT": "0.999"}),
            ("pixel", {"BENCH_MODEL": "pixel"}))
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        started = []
        for i, (label, extra) in enumerate(runs[2:] if pixel_only else runs):
            env = dict(os.environ)
            for k in ("BENCH_QUANT", "BENCH_DEEPCACHE", "BENCH_CALIB", "BENCH_STEPS",
                      "BENCH_RECORDS", "BENCH_MODEL"):
                env.pop(k, None)
            env.update(BENCH_BATCH=str(BATCH), BENCH_REPS="2",
                       BENCH_CACHE_DIR=os.path.join(tmp, str(i)), **extra)
            started.append((label, extra, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "d3roma_tpu_torch.bench"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            for label, extra, t0, proc in started:
                stdout, stderr = proc.communicate(timeout=600)
                out = stdout.strip().splitlines()
                print(f"bench ({label}): exit {proc.returncode} in "
                      f"{time.perf_counter() - t0:.1f}s; {out[-1] if out else ''}", flush=True)
                for ln in stderr.strip().splitlines()[-3:]:
                    print(f"  stderr: {ln}", flush=True)
                if proc.returncode != 0 or not out:
                    raise AssertionError(f"bench ({label}) failed: {stderr[-2000:]}")
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
        finally:
            for *_, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
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
    then one more; ms/frame is the faster of the two, as in `_timed_calls`.
    Checks the shapes
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
    t0 = time.perf_counter()
    run()
    _sync()
    walls.append(time.perf_counter() - t0)
    ms_per_frame = min(walls) * 1e3 / BATCH
    img, inter = out.images, out.intermediates
    print(f"{label}: {ms_per_frame:.2f} ms/frame, the faster of "
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


# the eval phase: procedural HISS frames, the eval preset's loader (640x360
# resized to its 480x270 camera, padded to 272x480), batch 2, 10 DDIM steps
EVAL_FRAMES = 4
EVAL_BATCH = 2
EVAL_PRESET = "eval_ldm_mixed_rgb+raw"
# self-attention sites of >= 512 tokens per UNet pass at a 272x480 input:
# the 34x60 = 2040-token level's (down block 0: 2, up block 3: 3); the
# 17x30 = 510-token level runs the plain attention
EVAL_ATTENTION_SITES = 5
EVAL_TRANSFORMER_BLOCKS = 16
# kernels against plain in the eval, on the same noise: each batch's
# prediction (pred_mean, denormalized) within EVAL_PRED_REL_TOL x its max
# |plain|. Each kernel call is one bf16 ulp from its plain version (REL_TOL);
# a UNet forward through them stays within UNET_REL_TOL of the plain one, and
# the prediction is the decoded x0 of the last step, a linear map of that
# forward's output and the latents. The same run on other noise must fail
# it, so the check can tell a sample from another.
EVAL_PRED_REL_TOL = UNET_REL_TOL
# depth/rel and disp/epe, |a - b| / |b|: means of per-pixel terms that move
# by at most the prediction's change at that pixel (| |a - g| - |b - g| | <=
# |a - b|); with one bf16 rounding's changes of either sign, a mean moves by
# less than one bf16 rounding, 2^-8 relative
EVAL_METRIC_REL_TOL = 2.0 ** -8
GOLDEN_ATOL = 5e-2  # golden.compare's own default, relative to each stage's max |ref|


def _eval_config(pipe_dir):
    from d3roma_tpu_torch.config import load_task_preset

    cfg = load_task_preset(EVAL_PRESET)
    cfg.resume_pretrained = pipe_dir
    cfg.eval_dataset = ["HISS"]
    cfg.eval_batch_size = EVAL_BATCH
    return cfg


def _clamp_share(pipe, batch, steps):
    """The share of output pixels at the clamp (|x| = 1) of one call."""
    import torch

    out = pipe(num_inference_steps=steps, num_intermediate_images=1, cond_channels="rgb+raw",
               rgb_images=batch["normalized_rgb"], sim_disp=batch["sim_disp"],
               generator=torch.Generator(device=pipe.device).manual_seed(3))
    return (out.images.abs() >= 1.0).float().mean().item()


def _predictions(fn):
    """fn()'s result and the prediction (pred_mean, host array) of each
    eval_batch call made in it, in order."""
    from d3roma_tpu_torch.evaluation import eval_loop

    preds = []
    inner = eval_loop.eval_batch

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        preds.append(out[0].copy())
        return out

    eval_loop.eval_batch = recording
    try:
        return fn(), preds
    finally:
        eval_loop.eval_batch = inner


def _pred_rel(preds, refs):
    """The worst batch's max |a - b| / max |b| over two runs' predictions."""
    import numpy as np

    if len(preds) != len(refs) or not refs:
        raise AssertionError(f"eval: {len(preds)} predictions against {len(refs)}")
    return max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
               for a, b in zip(preds, refs))


def _plain_bf16(fn):
    """fn() with the bf16 attention and GEGLU kernels' wrappers replaced by
    their plain versions (the same arithmetic as PyTorch ops, on the card)."""
    from d3roma_tpu_torch.models import layers
    from d3roma_tpu_torch.ops import kernels

    saved = layers.mha_attention, layers.geglu_ff
    layers.mha_attention, layers.geglu_ff = kernels.mha_attention_plain, kernels.geglu_ff_plain
    try:
        return fn()
    finally:
        layers.mha_attention, layers.geglu_ff = saved


def eval_phase():
    """Evaluation end to end (`python -m d3roma_tpu_torch.evaluate`) on the
    card, hermetic:

    - a full-width latent pipeline (SD2.1 geometry, seeded random weights in
      bf16) saved with the port's save_pretrained in a temporary directory.
      The share of one call's output pixels at the clamp (|x| = 1, one
      batch of the eval frames) is printed and must stay under half. The
      weights are saved as drawn: at the generator's seed 0 the share is
      0.4%, so no layer needs scaling;
    - 4 procedural HISS frames (640x360) from the port's generate_dataset in
      the same directory; one frame's PNGs and EXRs read back bit-equal to
      the renderer's arrays; the loader's host ms per frame, from one pass
      of the eval loader (its threads, PNG and EXR decode, resize);
    - `dp2_eval`: `distributed_evaluate` data parallel on two ranks of the
      card (torchrun, gloo) against the entry point's metrics line, the two
      run at the same time, beside the untimed checks in process below (the
      timed runs wait for them);
    - the entry point in its own process, with the temporary directory as
      its working directory: finite metrics for HISS and every artifact
      (the colourised predictions, the error map and the denoised grid, the
      HISS simDepthImage EXRs), each read back by the port's PNG and EXR
      readers;
    - in process, evaluate_dataset on the same frames, weights and
      generator seed through the kernels (fast_inference("latency")) and
      through their plain versions: the launches of the kernel run (row 1
      once per self-attention site of >= 512 tokens a UNet pass, row 2 once
      per transformer block a pass); each batch's prediction within
      EVAL_PRED_REL_TOL of the plain run's, depth/rel and disp/epe within
      EVAL_METRIC_REL_TOL; the plain run on other noise (generator seed 2)
      must fall outside EVAL_PRED_REL_TOL, so the check tells samples
      apart; eval ms/frame, the faster of two runs after a warm-up, and
      the device's idle share from one profiled run;
    - golden.dump through the plain versions at 272x480, golden.compare
      through the kernels: every stage within GOLDEN_ATOL.

    Returns a summary dict."""
    import tempfile
    import threading
    from functools import partial

    import numpy as np
    import torch

    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.evaluation import evaluate_dataset, golden
    from d3roma_tpu_torch.models import (
        AutoencoderKL,
        UNet2DCondition,
        init_random_,
        widened_in_channels,
    )
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
    from d3roma_tpu_torch.synthetic import ProceduralSceneRenderer, SceneConfig, generate_dataset
    from d3roma_tpu_torch.utils import png
    from d3roma_tpu_torch.utils.exr import read_exr

    summary = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)  # dataset roots are relative to the working directory
        try:
            t0 = time.perf_counter()
            generate_dataset(os.path.join(tmp, "datasets", "HISS"), EVAL_FRAMES, split="test",
                             seed=5)
            gen_s = time.perf_counter() - t0
            scene = os.path.join(tmp, "datasets", "HISS", "test", "scene_0000")
            frame = ProceduralSceneRenderer(SceneConfig(), 5).render()
            for name, got in (("rgb", png.read_png(os.path.join(scene, "0000_color.png"))),
                              ("ir_l", png.read_png(os.path.join(scene, "0000_ir_l.png"))),
                              ("ir_r", png.read_png(os.path.join(scene, "0000_ir_r.png"))),
                              ("depth", read_exr(os.path.join(scene, "0000_depth.exr"))),
                              ("sim_depth", read_exr(os.path.join(scene,
                                                                  "0000_simDepthImage.exr")))):
                if got.dtype != frame[name].dtype or not np.array_equal(got, frame[name]):
                    raise AssertionError(f"eval: frame 0's {name} did not read back bit-equal")
            pipe_dir = os.path.join(tmp, "pipe")
            cfg = _eval_config(pipe_dir)
            t0 = time.perf_counter()
            loaded = list(val_loaders(cfg)[0])
            loader_ms = (time.perf_counter() - t0) * 1e3 / EVAL_FRAMES
            if sum(len(b["depth"]) for b in loaded) != EVAL_FRAMES:
                raise AssertionError(f"eval: the loader gave {len(loaded)} batches")
            print(f"eval: {EVAL_FRAMES} frames generated in {gen_s:.1f}s, frame 0 read back "
                  f"bit-equal; the loader's host {loader_ms:.2f} ms/frame", flush=True)
            summary["loader_ms_per_frame"] = loader_ms

            gen = torch.Generator(device="cuda").manual_seed(0)
            unet = init_random_(UNet2DCondition(in_channels=widened_in_channels("rgb+raw"),
                                                out_channels=4, device="cuda"), gen)
            vae = init_random_(AutoencoderKL(device="cuda"), gen)
            norm = Normalizer.from_config(cfg)
            pipe = GuidedLatentDiffusionPipeline(
                unet=unet, vae=vae, text_embed=torch.zeros(1, 2, 1024),
                spec=create_sampler_spec(cfg, train=False), normalizer=norm,
                device="cuda").half_precision()
            pre = partial(preprocess_eval, config=cfg, normalizer=norm, device="cuda")
            with torch.no_grad():
                share = _clamp_share(pipe, pre(loaded[0]), cfg.num_inference_timesteps)
            print(f"eval: {share:.5f} of one call's output pixels at the clamp (limit 0.5)",
                  flush=True)
            if not share < 0.5:
                raise AssertionError(f"eval: {share:.3f} of the output pixels at the clamp")
            summary["clamp_share"] = share
            t0 = time.perf_counter()
            pipe.save_pretrained(pipe_dir)
            print(f"eval: save_pretrained in {time.perf_counter() - t0:.1f}s", flush=True)

            # the entry point, as a user runs it, in its own process, and at
            # the same time the same evaluation data parallel on two ranks;
            # meanwhile the untimed checks in process (the timed runs wait
            # for the children)
            children = {}

            def entry_points():
                try:
                    children["dp2"] = dp2_eval(tmp, repo, pipe_dir)
                except BaseException as e:  # raised after the join
                    children["error"] = e

            side = threading.Thread(target=entry_points)
            side.start()
            try:
                # in process: the kernels against their plain versions
                pipe.fast_inference("latency")

                def run(seed=1):
                    return evaluate_dataset(cfg, pipe, val_loaders(cfg)[0],
                                            torch.Generator().manual_seed(seed), preprocess=pre)[0]

                _zero_launches()
                fast, fast_preds = _predictions(run)
                _sync()
                counts = _int8_launches()
                passes = cfg.num_inference_timesteps * EVAL_FRAMES // EVAL_BATCH
                _check_counts("eval latency", counts,
                              {"attention": EVAL_ATTENTION_SITES * passes,
                               "geglu": EVAL_TRANSFORMER_BLOCKS * passes})
                plain, plain_preds = _plain_bf16(lambda: _predictions(run))
                control, control_preds = _plain_bf16(lambda: _predictions(lambda: run(seed=2)))
                pred_rel = _pred_rel(fast_preds, plain_preds)
                control_rel = _pred_rel(control_preds, plain_preds)
                print(f"eval: predictions, max |kernels - plain| / max |plain| over "
                      f"{len(plain_preds)} batches {pred_rel:.3e} (tol {EVAL_PRED_REL_TOL}); plain "
                      f"on other noise {control_rel:.3e} (must exceed the tol)", flush=True)
                errs, control_errs = {}, {}
                for grp, key in (("depth", "rel"), ("disp", "epe")):
                    a, b, c = fast[grp][key], plain[grp][key], control[grp][key]
                    errs[f"{grp}/{key}"] = abs(a - b) / max(abs(b), 1e-12)
                    control_errs[f"{grp}/{key}"] = abs(c - b) / max(abs(b), 1e-12)
                    print(f"eval: {grp}/{key} kernels {a:.6f} plain {b:.6f} rel diff "
                          f"{errs[f'{grp}/{key}']:.3e} (tol {EVAL_METRIC_REL_TOL:.3e}); plain on "
                          f"other noise {c:.6f}, {control_errs[f'{grp}/{key}']:.3e}", flush=True)
                if not (np.isfinite(pred_rel) and pred_rel <= EVAL_PRED_REL_TOL):
                    raise AssertionError(f"eval: predictions, kernels against plain {pred_rel}")
                if not control_rel > EVAL_PRED_REL_TOL:
                    raise AssertionError(f"eval: other noise within the tolerance ({control_rel})")
                if (not all(np.isfinite(list(errs.values())))
                        or max(errs.values()) > EVAL_METRIC_REL_TOL):
                    raise AssertionError(f"eval: kernels against plain {errs}")

                # golden stages: dumped through the plain versions, compared through the kernels
                gdir = os.path.join(tmp, "golden")
                _plain_bf16(lambda: golden.dump(pipe, gdir, H=272, W=480, seed=0))
                report = golden.compare(pipe, gdir, atol=GOLDEN_ATOL)
                worst = max(r.get("rel", float("inf")) for r in report.values())
                print(f"eval: golden stages "
                      f"{[(k, round(r.get('rel', -1), 5)) for k, r in report.items()]}"
                      f" (ok within {GOLDEN_ATOL} of each stage's max |ref|)", flush=True)
                if not all(r["ok"] for r in report.values()):
                    raise AssertionError(f"eval: golden stages {report}")
                summary["golden_worst_rel"] = worst
            finally:
                side.join()
            if "error" in children:
                raise children["error"]
            summary["dp2"] = children["dp2"]
            line = summary["dp2"].pop("evaluate_line")
            print(f"eval: entry point {line}", flush=True)
            flat = [v for grp in ("disp", "depth") for v in line["metrics"][grp].values()]
            if line["dataset"] != "HISS" or not all(np.isfinite(flat)):
                raise AssertionError(f"eval entry point: bad metrics {line}")
            art = os.path.join(tmp, line["output_dir"])
            read = 0
            for i in range(EVAL_FRAMES // EVAL_BATCH):
                for b in range(EVAL_BATCH):
                    img = png.read_png(os.path.join(art, f"idx{i}_{b}_pred_disp.png"))
                    depth = read_exr(os.path.join(art, f"idx{i}_{b}_simDepthImage.exr"))
                    if img.shape != (270, 480, 3) or depth.shape != (270, 480):
                        raise AssertionError(f"eval artifacts: {img.shape} {depth.shape}")
                    read += 2
                for name in (f"idx{i}_error.png", f"idx{i}_denoised.png"):
                    if png.read_png(os.path.join(art, name)).ndim != 3:
                        raise AssertionError(f"eval artifact {name}")
                    read += 1
            print(f"eval: entry point wrote {read} artifacts, each read back", flush=True)
            summary["entry_point_metrics"] = line["metrics"]

            # timed: alone on the card under --eval; in the whole pass beside
            # the multi-rank train runs' TP2 ranks (started before this
            # phase, for the time limit), whose host-staged collectives share
            # the host's cores
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                _sync()
                walls.append((time.perf_counter() - t0) * 1e3 / EVAL_FRAMES)
            wall_ms, busy_ms = profile_phase(run, "eval", frames=EVAL_FRAMES)
            idle = max(0.0, 1 - busy_ms / wall_ms)
            ms = min(walls)
            print(f"eval: {ms:.2f} ms/frame, the faster of {[round(w, 2) for w in walls]} "
                  f"({EVAL_FRAMES} frames, batch {EVAL_BATCH}, {cfg.num_inference_timesteps} "
                  f"steps, 272x480); profiled run device busy {busy_ms / EVAL_FRAMES:.2f} "
                  f"ms/frame, idle share {idle:.3f}", flush=True)
            summary.update(launches={k: v for k, v in counts.items() if v}, ms_per_frame=ms,
                           device_busy_ms_per_frame=busy_ms / EVAL_FRAMES, idle_share=idle,
                           pred_rel=pred_rel, control_pred_rel=control_rel,
                           kernels_vs_plain=errs, control_vs_plain=control_errs,
                           metrics=fast, metrics_plain=plain)
        finally:
            os.chdir(cwd)
    del pipe, unet, vae
    torch.cuda.empty_cache()
    return summary


TRAIN_PRESET = "train_ldm_mixed_rgb+raw"
TRAIN_FRAMES = 24  # per dataset: 48 frames, 3 steps of batch 16 an epoch
TRAIN_EVAL_FRAMES = 4
SCENEFLOW_HW = (540, 960)  # the dataset's frames
TRAIN_BATCH = 16
TRAIN_HW = (184, 320)  # the preset's 180x320 crop, padded to divis_by 8
TRAIN_TIMED_STEPS = 4  # the median of the steps after the first two
# Card against CPU, one fp32 AdamW step of a narrow latent model (TF32
# off on the card): loss within 1e-4 and grad_norm within 1e-3 relative
# (fp32 sums in other orders, cuDNN's and the CPU's: a few ulps of each
# activation, far below what a wrong op gives); the parameters after the
# step within 2 learning rates everywhere and within 1e-3 of one for 99.9%
# of the elements outside the key biases. AdamW's first update is lr times
# the sign of the gradient: an element whose gradient is at the rounding
# level moves by lr either way (the key biases' gradient is zero in exact
# arithmetic), every other element the same to a few ulps.
TRAIN_LOSS_REL_TOL = 1e-4
TRAIN_GRAD_NORM_REL_TOL = 1e-3
TRAIN_NARROW_UNET = dict(
    in_channels=12, out_channels=4, block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
    attention_head_dim=32, cross_attention_dim=64, norm_groups=8)
TRAIN_NARROW_VAE = dict(block_out_channels=(32, 64), norm_groups=8)


def _write_sceneflow(root: str, n: int, seed: int) -> None:
    """n frames in SceneFlow's FlyingThings3D layout at the dataset's
    960x540: left and right PNGs (blocky random textures), the disparity
    PFM and the raw (SGM) disparity PFM beside it."""
    import numpy as np

    from d3roma_tpu_torch.utils import png
    from d3roma_tpu_torch.utils.frame_utils import writePFM

    rs = np.random.RandomState(seed)
    h, w = SCENEFLOW_HW
    sub = os.path.join(root, "FlyingThings3D", "{}", "TRAIN", "A", "0000", "{}")
    for kind, side in (("frames_cleanpass", "left"), ("frames_cleanpass", "right"),
                       ("disparity", "left"), ("raw_cleanpass", "left")):
        os.makedirs(sub.format(kind, side), exist_ok=True)
    for i in range(n):
        for side in ("left", "right"):
            tex = rs.randint(0, 256, (h // 10, w // 10, 3)).astype(np.uint8)
            png.write_png(os.path.join(sub.format("frames_cleanpass", side), f"{i:04d}.png"),
                          np.kron(tex, np.ones((10, 10, 1), np.uint8)))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        disp = (20 + 60 * (xx / w) + 10 * np.sin(yy / 37.0 + i)).astype(np.float32)
        writePFM(os.path.join(sub.format("disparity", "left"), f"{i:04d}.pfm"), disp)
        raw = disp + rs.standard_normal(disp.shape).astype(np.float32)
        writePFM(os.path.join(sub.format("raw_cleanpass", "left"), f"{i:04d}.pfm"), raw)


# the train phase's arguments of the entry point (after task=TRAIN_PRESET)
TRAIN_ARGS = ["task.train_dataset=[SceneFlow,HISS]", "task.dataset_weight=[1,1]",
              "task.eval_dataset=[HISS]", "task.val_every_global_steps=3", "task.eval_num_batch=1",
              "task.save_model_epochs=1"]


def _train_run(tmp, repo, extra, tp2=None):
    """The train entry point in its own process in `tmp` (through
    `first_epoch_child` where `tp2` is (the TP2 run's directory, the file
    of the agreement of its step-1 state with this run's)); returns its
    step log lines [(step, loss, grad_norm)] and the whole log."""
    t0 = time.perf_counter()
    entry = (["-m", "d3roma_tpu_torch.train"] if tp2 is None else
             [os.path.join(repo, "chip_smoke.py"), "--train-first-epoch", *tp2])
    proc = subprocess.run(
        [sys.executable] + entry + [f"task={TRAIN_PRESET}"] + TRAIN_ARGS
        + ["task.output_dir=run"] + list(extra),
        cwd=tmp, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train entry point failed ({proc.returncode}): "
                             f"{proc.stderr[-4000:]}")
    with open(os.path.join(tmp, "run", "train.log")) as f:
        log = f.read()
    return _logged_steps(log), log, wall


def _logged_steps(log: str) -> list:
    """(step, loss, grad_norm) of every step line of a train.log."""
    steps = []
    for line in log.splitlines():
        parts = line.split()
        if "loss" in parts and "grad_norm" in parts and "step" in parts:
            steps.append((int(parts[parts.index("step") + 1]),
                          float(parts[parts.index("loss") + 1]),
                          float(parts[parts.index("grad_norm") + 1])))
    return steps


def _wait_for_best(tmp: str, proc, label: str) -> None:
    """Return once tmp/run/train.log says best/ was exported or the train
    process has ended; kill it after 900 s without."""
    log_path = os.path.join(tmp, "run", "train.log")
    deadline = time.perf_counter() + 900
    while proc.poll() is None:
        if os.path.exists(log_path):
            with open(log_path) as f:
                if "exported best/" in f.read():
                    return
        if time.perf_counter() > deadline:
            proc.kill()
            proc.wait()
            raise AssertionError(f"{label}: the train entry point exported no best/ in 900 s")
        time.sleep(0.5)


class _Recorded:
    """A train step's draws: taken from `draws` and kept on a tape, or, with
    no `draws`, given back from `tape` in the same order."""

    def __init__(self, draws=None, tape=None):
        self.draws, self.tape = draws, tape if tape is not None else []

    def _take(self, name, *args):
        if self.draws is not None:
            out = getattr(self.draws, name)(*args)
            self.tape.append(out.clone())
            return out
        return self.tape.pop(0)

    def normal(self, shape, dtype=None):
        import torch

        return self._take("normal", shape, dtype or torch.float32)

    def randint(self, low, high, n):
        return self._take("randint", low, high, n)

    def categorical(self, probs, n):
        return self._take("categorical", probs, n)


def _narrow_step(device, cfg, state_dict, vae_state, text, batch, draws, sampler):
    """One train step of the narrow latent model on `device` from the given
    weights; returns (metrics on the host, the UNet's state dict on the
    host)."""
    import torch

    from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from d3roma_tpu_torch.training import build_optimizer, create_train_state, make_train_step

    unet = UNet2DCondition(**TRAIN_NARROW_UNET, remat=True, device=device)
    unet.load_state_dict(state_dict)
    vae = AutoencoderKL(**TRAIN_NARROW_VAE, device=device).requires_grad_(False)
    vae.load_state_dict(vae_state)
    opt = build_optimizer(cfg, 3, list(unet.parameters()))
    state = create_train_state(cfg, unet, 3, optimizer=opt)
    step = make_train_step(cfg, unet, opt, cfg.schedule_config(train=True).tables(device),
                           vae=vae, text_embed=text.to(device), t_sampler=sampler)
    on = {k: v.to(device) for k, v in batch.items()}
    if device != "cpu":
        _sync()
        torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(state, on, draws)
    finally:
        if device != "cpu":
            torch.cuda.set_sync_debug_mode(0)
    host = {k: v.detach().cpu() for k, v in metrics.items()}
    return host, {k: v.detach().cpu() for k, v in unet.state_dict().items()}


def _param_diffs(ours, ref):
    import numpy as np

    diffs = {k: (ours[k] - ref[k]).abs().flatten().numpy() for k in ref}
    every = np.concatenate(list(diffs.values()))
    rest = np.concatenate([d for k, d in diffs.items() if not k.endswith("to_k.bias")])
    return float(every.max()), float(np.quantile(rest, 0.999))


def train_card_vs_cpu(cfg):
    """One fp32 train step of a narrow latent model (two levels, widths 32
    and 64) on the card and on the CPU from the same weights, batch and
    draws (recorded on the CPU, replayed on the card), for each timestep
    sampler; the card's step runs under set_sync_debug_mode("error"). Then
    one card step drawing from a CUDA generator (the loss-aware sampler's
    categorical draw on the card), under the same mode."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition, init_random_
    from d3roma_tpu_torch.ops.noise import GeneratorDraws
    from d3roma_tpu_torch.training.train_loop import fp32_math

    gen = torch.Generator().manual_seed(11)
    unet = init_random_(UNet2DCondition(**TRAIN_NARROW_UNET, device="cpu"), gen)
    vae = init_random_(AutoencoderKL(**TRAIN_NARROW_VAE, device="cpu"), gen)
    sd, vsd = unet.state_dict(), vae.state_dict()
    text = torch.randn(1, 2, TRAIN_NARROW_UNET["cross_attention_dim"], generator=gen)
    rs = np.random.RandomState(3)
    disp = rs.uniform(-0.9, 0.9, (2, 64, 96, 1)).astype(np.float32)
    batch = {"normalized_disp": torch.from_numpy(disp),
             "sim_disp": torch.from_numpy(np.clip(disp + 0.05 * rs.standard_normal(disp.shape),
                                                  -1, 1).astype(np.float32)),
             "normalized_rgb": torch.from_numpy(rs.uniform(-1, 1, (2, 64, 96, 3))
                                                .astype(np.float32)),
             "mask": torch.from_numpy((rs.rand(2, 64, 96, 1) > 0.2).astype(np.float32))}
    batch["left_image"] = batch["right_image"] = batch["normalized_rgb"]
    lr = cfg.learning_rate
    out = {}
    for sampler in ("uniform", "loss-second-moment"):
        rec = _Recorded(GeneratorDraws(torch.Generator().manual_seed(5)))
        cpu, cpu_sd = _narrow_step("cpu", cfg, sd, vsd, text, batch, rec, sampler)
        # the tape is on the card before the step: a copy from the host syncs
        tape = [t.to("cuda") for t in rec.tape]
        with fp32_math(torch.device("cuda")):
            card, card_sd = _narrow_step("cuda", cfg, sd, vsd, text, batch,
                                         _Recorded(tape=tape), sampler)
        rel = {k: abs(float(card[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-30)
               for k in ("loss", "grad_norm", "recon_mae")}
        worst, q999 = _param_diffs(card_sd, cpu_sd)
        print(f"train card vs CPU ({sampler}): loss {float(card['loss']):.7f} / "
              f"{float(cpu['loss']):.7f} rel {rel['loss']:.2e} (tol {TRAIN_LOSS_REL_TOL}); "
              f"grad_norm rel {rel['grad_norm']:.2e} (tol {TRAIN_GRAD_NORM_REL_TOL}); recon_mae "
              f"rel {rel['recon_mae']:.2e}; params max |diff| {worst:.3e} (tol {2 * lr:.1e}), "
              f"99.9% {q999:.3e} (tol {1e-3 * lr:.1e}); no host sync in the card's step",
              flush=True)
        if not (torch.equal(card["timesteps"], cpu["timesteps"])
                and rel["loss"] <= TRAIN_LOSS_REL_TOL
                and rel["grad_norm"] <= TRAIN_GRAD_NORM_REL_TOL
                and rel["recon_mae"] <= TRAIN_GRAD_NORM_REL_TOL
                and worst <= 2 * lr and q999 <= 1e-3 * lr):
            raise AssertionError(f"train card vs CPU ({sampler}): {rel} {worst} {q999}")
        out[sampler] = dict(rel, params_max_abs=worst, params_q999=q999)
    with fp32_math(torch.device("cuda")):
        card, _ = _narrow_step("cuda", cfg, sd, vsd, text, batch,
                               GeneratorDraws(torch.Generator(device="cuda").manual_seed(5)),
                               "loss-second-moment")
    if not (torch.isfinite(card["loss"]) and torch.isfinite(card["grad_norm"])):
        raise AssertionError("train: the card's own draws gave a non-finite step")
    print("train: a step drawing from a CUDA generator (loss-aware sampler) made no host sync",
          flush=True)
    return out


def _train_batch(gen):
    """A preprocessed batch of the full-width run's shape on the card."""
    import torch

    b, (h, w) = TRAIN_BATCH, TRAIN_HW
    disp = torch.rand(b, h, w, 1, generator=gen, device="cuda") * 1.8 - 0.9
    return {"normalized_disp": disp,
            "sim_disp": (disp + 0.05 * torch.randn(disp.shape, generator=gen, device="cuda"))
            .clamp(-1, 1),
            "normalized_rgb": torch.rand(b, h, w, 3, generator=gen, device="cuda") * 2 - 1,
            "left_image": torch.zeros(b, h, w, 3, device="cuda"),
            "right_image": torch.zeros(b, h, w, 3, device="cuda"),
            "mask": torch.ones(b, h, w, 1, device="cuda")}


_TRAIN_RANGES = ("vae_encode", "forward", "recon_decode", "backward", "optimizer", "sampler")
_TRAIN_KERNEL_CLASSES = (
    ("convolution forward", ("fprop", "implicit_convolve", "conv2d_c1_k1", "xmma_fprop")),
    ("convolution backward (data)", ("dgrad",)),
    ("convolution backward (weights)", ("wgrad", "conv_c1_k1_wgrad")),
    ("group norm", ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                    "compute_internal_gradients", "gamma_beta_backward")),
    ("softmax", ("softmax",)),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_xmma", "splitk")),
)


def _kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in _TRAIN_KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise and other"


def train_timing(cfg):
    """Full width (SD2.1 UNet and VAE, random weights), batch 16 at 184x320,
    in cfg's precision (fp32, or bf16 compute over fp32 parameters), TF32
    off: TRAIN_TIMED_STEPS steps on a batch on the card, each
    synchronized; ms/step the median of the steps after the first two,
    samples/s, peak memory; no hand-written kernel launched; one more step
    under torch.profiler: its idle share and device ms by phase and by
    kernel class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d3roma_tpu_torch.ops.noise import GeneratorDraws
    from d3roma_tpu_torch.training import (
        build_models,
        build_optimizer,
        create_train_state,
        make_train_step,
    )
    from d3roma_tpu_torch.training.train_loop import fp32_math, step_draws

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    models = build_models(cfg, 0, "cuda")
    unet = models["unet"]
    opt = build_optimizer(cfg, 3, list(unet.parameters()))
    state = create_train_state(cfg, unet, 3, optimizer=opt)
    step = make_train_step(cfg, unet, opt, cfg.schedule_config(train=True).tables("cuda"),
                           vae=models["vae"], text_embed=models["text_embed"])
    batch = _train_batch(torch.Generator(device="cuda").manual_seed(1))
    walls, losses = [], []
    _zero_launches()
    with fp32_math(torch.device("cuda")):
        for i in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            m = step(state, batch, step_draws(0, i, torch.device("cuda")))
            _sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        counts = {k: v for k, v in _int8_launches().items() if v}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch, GeneratorDraws(torch.Generator(device="cuda").manual_seed(9)))
            _sync()
            prof_wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts:
        raise AssertionError(f"train: hand-written kernels launched in training: {counts}")
    import math

    if not all(math.isfinite(x) for pair in losses for x in pair):
        raise AssertionError(f"train timing: non-finite loss or grad_norm {losses}")
    ranges, classes, busy, top = {}, {}, 0.0, []
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        on_device = getattr(evt, "device_type", None) == cuda
        if evt.name.startswith("train_step/"):
            # the host-side range sums its ops' kernels; the profiler also
            # draws each range on the device's timeline, as a span
            if not on_device:
                name = evt.name.split("/", 1)[1]
                ranges[name] = ranges.get(name, 0.0) + evt.device_time_total / 1e3
            continue
        if on_device and "Sync" not in evt.name:
            ms = evt.device_time_total / 1e3
            busy += ms
            c = _kernel_class(evt.name)
            classes[c] = classes.get(c, 0.0) + ms
            top.append((ms, evt.name))
    # the forward range holds the recon decode's; the backward pass runs on
    # autograd's device thread, outside every range: what no range holds
    ranges["forward"] = ranges.get("forward", 0.0) - ranges.get("recon_decode", 0.0)
    ranges["backward"] = busy - sum(v for k, v in ranges.items() if k != "backward")
    ms = statistics.median(walls[2:])
    idle = max(0.0, 1 - busy / prof_wall)
    precision = "bf16" if cfg.mixed_precision in ("bf16", "fp16") else "fp32"
    print(f"train (full width, batch {TRAIN_BATCH}, {TRAIN_HW[0]}x{TRAIN_HW[1]}, {precision}): "
          f"{ms:.1f} ms/step, median of {[round(w, 1) for w in walls[2:]]} (first two "
          f"{[round(w, 1) for w in walls[:2]]}); {TRAIN_BATCH / ms * 1e3:.2f} samples/s; peak "
          f"memory {peak:.2f} GiB; profiled step {prof_wall:.1f} ms wall, device busy "
          f"{busy:.1f} ms, idle share {idle:.3f}; losses {[round(l, 4) for l, _ in losses]}",
          flush=True)
    print(f"  by phase (device ms): {json.dumps({k: round(v, 2) for k, v in ranges.items()})}",
          flush=True)
    print(f"  by kernel class (device ms): "
          f"{json.dumps({k: round(v, 2) for k, v in sorted(classes.items(), key=lambda kv: -kv[1])})}",
          flush=True)
    totals = {}
    for ms_, name in top:
        totals[name] = totals.get(name, 0.0) + ms_
    for name, ms_ in sorted(totals.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  top: {ms_:9.2f} ms {name[:110]}", flush=True)
    del models, unet, opt, state, step, batch
    torch.cuda.empty_cache()
    return dict(ms_per_step=ms, step_walls_ms=walls, samples_per_s=TRAIN_BATCH / ms * 1e3,
                peak_memory_gib=peak, profiled_wall_ms=prof_wall, device_busy_ms=busy,
                idle_share=idle, device_ms_by_phase=ranges, device_ms_by_kernel_class=classes)


def _fp32_checkpoint_and_export(run: str, export: str):
    """Every parameter and optimizer tensor of run's checkpoints/last
    state.pt and every leaf of the export's params.msgpack files fp32, the
    UNet's leaves equal to the checkpoint's parameters. Returns the counts
    checked."""
    import torch

    from d3roma_tpu_torch.models import flax_unet_to_torch
    from d3roma_tpu_torch.utils import flax_msgpack

    sd = torch.load(os.path.join(run, "checkpoints", "last", "state.pt"), map_location="cpu",
                    weights_only=True, mmap=True)
    params = sd["params"]
    opt = [t for v in sd["opt_state"].values() for t in (v if isinstance(v, list) else [v])
           if t.is_floating_point()]
    bad = [k for k, v in params.items() if v.dtype != torch.float32]
    bad += [f"opt_state tensor {t.dtype}" for t in opt if t.dtype != torch.float32]
    leaves = {}
    for part in ("unet", "vae"):
        tree = flax_msgpack.load(os.path.join(export, part, "params.msgpack"))
        leaves[part] = flax_unet_to_torch(tree) if part == "unet" else None
        stack = [tree]
        while stack:
            node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append(v)
                elif v.dtype != torch.float32:
                    bad.append(f"{part} leaf {k} {v.dtype}")
    bad += [k for k, v in leaves["unet"].items() if not torch.equal(v, params[k])]
    if bad:
        raise AssertionError(f"train: not fp32 or not the checkpoint's: {bad[:10]}")
    return dict(params=len(params), opt_tensors=len(opt), unet_leaves=len(leaves["unet"]))


def _write_train_frames(tmp: str) -> None:
    """The train entry point's frames in tmp/datasets: TRAIN_FRAMES
    procedural HISS frames (640x360) in `train` and TRAIN_EVAL_FRAMES in the
    split the preset's HISS eval loader reads, and TRAIN_FRAMES SceneFlow
    frames at the dataset's 960x540."""
    from d3roma_tpu_torch.config import compose
    from d3roma_tpu_torch.synthetic import generate_dataset

    cfg = compose([f"task={TRAIN_PRESET}"]).task
    t0 = time.perf_counter()
    generate_dataset(os.path.join(tmp, "datasets", "HISS"), TRAIN_FRAMES, split="train",
                     seed=3)
    generate_dataset(os.path.join(tmp, "datasets", "HISS"), TRAIN_EVAL_FRAMES,
                     split=cfg.eval_split, seed=4)
    _write_sceneflow(os.path.join(tmp, "datasets", "SceneFlow"), TRAIN_FRAMES, seed=6)
    print(f"train: {2 * TRAIN_FRAMES + TRAIN_EVAL_FRAMES} frames written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def _first_epoch(tmp: str, repo: str, extra=(), frames: bool = True, tp2=None):
    """Frames (unless written already), then one epoch of the train entry
    point (3 steps of batch 16, the in-training eval at step 3) from random
    weights in `tmp`, in fp32 or with `extra`'s precision (its step-1 state
    held to a TP2 run's, `tp2` as `_train_run` takes it): every logged loss
    and grad_norm finite, the eval logged, checkpoints/last, best/ and
    epoch_0000/ written. Returns (run directory, summary)."""
    import numpy as np

    if frames:
        _write_train_frames(tmp)
    steps, log, wall = _train_run(tmp, repo, ["task.num_epochs=1"] + list(extra), tp2)
    run = os.path.join(tmp, "run")
    with open(os.path.join(run, "checkpoints", "last", "counter.json")) as f:
        counter = json.load(f)
    print(f"train: entry point {' '.join(extra) or 'fp32'}, 1 epoch in {wall:.1f}s; steps "
          f"{steps}; counter {counter}", flush=True)
    if [s for s, _, _ in steps] != [1, 2, 3] or not all(
            np.isfinite([l for _, l, _ in steps] + [g for _, _, g in steps])):
        raise AssertionError(f"train: steps {steps}\n{log[-3000:]}")
    if counter["global_step"] != 3 or counter["epoch"] != 1 or "eval[0] @3:" not in log:
        raise AssertionError(f"train: counter {counter} or no eval at step 3\n{log[-3000:]}")
    for name in ("checkpoints/last/state.pt", "best/model_index.json",
                 "epoch_0000/unet/params.msgpack", "epoch_0000/vae/params.msgpack"):
        if not os.path.exists(os.path.join(run, name)):
            raise AssertionError(f"train: {name} not written")
    return run, dict(steps=steps, wall_s=wall, counter=counter)


def train_phase(tmp: str, multi: "TrainParallel" = None):
    """Training end to end on the card, hermetic (in `tmp`, which the
    accuracy phase reads after it). With `multi`, the multi-rank runs
    already started in `tmp` (`train_parallel_start`, which wrote the
    frames): the first epoch keeps its step-1 state and tells them when it
    is done, and no timed step runs (the caller runs it alone on the card
    after `train_parallel_join`):

    - frames in a temporary `datasets/` tree (`_write_train_frames`; one
      epoch: 3 steps of batch 16);
    - `python -m d3roma_tpu_torch.train task=train_ldm_mixed_rgb+raw
      task.train_dataset=[SceneFlow,HISS] task.dataset_weight=[1,1]
      task.eval_dataset=[HISS] task.num_epochs=1 task.val_every_global_steps=3
      task.eval_num_batch=1 task.save_model_epochs=1` in its own process:
      full SD2.1 width, random weights, batch 16, 180x320, fp32,
      v-prediction, the preset's AdamW. Every logged loss and grad_norm
      finite; the in-training eval at step 3; checkpoints/last (with
      AdamW's moments), best/ and epoch_0000/ written; epoch_0000/ loads
      through from_pretrained and one pipeline call on it is finite. Then
      again with task.num_epochs=2 task.mixed_precision=bf16: it resumes the
      fp32 checkpoint (parameters and AdamW moments) at global step 3 and
      ends at 6 in bf16 compute over the fp32 parameters (the JAX bf16
      template's parameters are fp32 too), its in-training eval at step 6;
      every loss finite, state.pt and the epoch_0001/ export fp32, the
      export's UNet equal to the checkpoint's parameters;
    - one step of a narrow latent model on the card against the CPU
      (`train_card_vs_cpu`), no host sync inside the card's step; it and the
      epoch_0000/ call run beside the resumed run's process;
    - the full-width step's ms, samples/s, peak memory and a profiled step
      (`train_timing`), alone on the card.

    Returns a summary dict."""
    from d3roma_tpu_torch.config import compose

    summary = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = compose([f"task={TRAIN_PRESET}"]).task
    if multi is None:
        run, summary["epoch_1"] = _first_epoch(tmp, repo)
        _train_resumed(tmp, repo, cfg, run, summary)
        summary["timing"] = train_timing(cfg)
        return summary
    run, summary["epoch_1"] = _first_epoch(tmp, repo, frames=False, tp2=multi.first_epoch_args)
    multi.first_epoch_done(run)
    _train_resumed(tmp, repo, cfg, run, summary)
    return summary


def _train_resumed(tmp, repo, cfg, run, summary) -> None:
    """The train phase after the first epoch: the resumed bf16 run, with the
    export's call and the narrow card-against-CPU step beside it."""
    import threading

    import numpy as np
    import torch

    from d3roma_tpu_torch.config import compose
    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline

    # the resumed bf16 run in its own process; meanwhile, the epoch export
    # loaded and called, then removed (the resumed run writes epoch_0001/,
    # never epoch_0000/), and the narrow card-against-CPU step (neither
    # reads what the resumed run writes; the timed step waits for it).
    # best/, checked and read by nothing after, goes before the resumed
    # run starts: that run may export best/ anew at its eval. Both go for
    # room on the machine's disk.
    shutil.rmtree(os.path.join(run, "best"))
    resumed = {}

    def resume():
        try:
            resumed["run"] = _train_run(tmp, repo, ["task.num_epochs=2",
                                                    "task.mixed_precision=bf16"])
        except BaseException as e:  # raised after the join
            resumed["error"] = e

    side = threading.Thread(target=resume)
    side.start()
    try:
        pipe = GuidedLatentDiffusionPipeline.from_pretrained(os.path.join(run, "epoch_0000"),
                                                             device="cuda")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            eval_cfg = compose([f"task={TRAIN_PRESET}", "task.eval_dataset=[HISS]"]).task
            batch = preprocess_eval(next(iter(val_loaders(eval_cfg)[0])), eval_cfg,
                                    Normalizer.from_config(eval_cfg), "cuda")
        finally:
            os.chdir(cwd)
        rgb, raw = batch["normalized_rgb"], batch["sim_disp"]
        pad = (-rgb.shape[1]) % 8
        rgb = torch.nn.functional.pad(rgb, (0, 0, 0, 0, 0, pad), mode="replicate")
        raw = torch.nn.functional.pad(raw, (0, 0, 0, 0, 0, pad), mode="replicate")
        out = pipe(num_inference_steps=eval_cfg.num_inference_timesteps,
                   num_intermediate_images=1, cond_channels="rgb+raw", rgb_images=rgb,
                   sim_disp=raw, generator=torch.Generator(device="cuda").manual_seed(0))
        if not torch.isfinite(out.images).all():
            raise AssertionError("train: the exported pipeline's output is not finite")
        print(f"train: epoch_0000/ loaded through from_pretrained; one call "
              f"{tuple(out.images.shape)} finite in [{out.images.min().item():.4f}, "
              f"{out.images.max().item():.4f}]", flush=True)
        del pipe, out
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(run, "epoch_0000"))
        summary["card_vs_cpu"] = train_card_vs_cpu(cfg)
    finally:
        side.join()
    if "error" in resumed:
        raise resumed["error"]
    steps2, log2, wall2 = resumed["run"]
    with open(os.path.join(run, "checkpoints", "last", "counter.json")) as f:
        counter2 = json.load(f)
    print(f"train: resumed run in bf16 in {wall2:.1f}s; steps {steps2}; counter {counter2}",
          flush=True)
    if ("resuming from" not in log2 or [s for s, _, _ in steps2][-3:] != [4, 5, 6]
            or not all(np.isfinite([l for _, l, _ in steps2] + [g for _, _, g in steps2]))
            or counter2["global_step"] != 6 or counter2["epoch"] != 2 or "eval[0] @6:" not in log2
            or not os.path.exists(os.path.join(run, "epoch_0001", "model_index.json"))):
        raise AssertionError(f"train: resume {steps2} {counter2}\n{log2[-3000:]}")
    checked = _fp32_checkpoint_and_export(run, os.path.join(run, "epoch_0001"))
    print(f"train: the bf16 run's state.pt ({checked['params']} parameters, "
          f"{checked['opt_tensors']} optimizer tensors) and epoch_0001/ leaves fp32, the "
          f"export's UNet ({checked['unet_leaves']} leaves) equal to the checkpoint's",
          flush=True)
    summary["epoch_2_bf16"] = dict(steps=steps2[-3:], wall_s=wall2, counter=counter2,
                                   fp32_checked=checked)


TRAIN_PARALLEL_RANKS = 2  # both ranks on the one card: gloo, collectives staged through the host
TRAIN_PARALLEL_TIMEOUT = 900  # s a torchrun may take: a rank that hangs fails the phase
# a rank's share of the card it shares with the one-process runs: PyTorch's
# cuDNN tries the next convolution plan when a plan's workspace does not
# fit, and one TP2 rank took a plan of ~19 GiB for the sharded VAE's
# full-resolution convs (a 43.64 GiB peak against the other rank's 24.33)
TRAIN_PARALLEL_MEMORY_FRACTION = 0.4
# DP2 against the one-process first epoch: the train step tests' tolerances
# (tests/test_torch_train_step.py): loss within 1e-5 and grad_norm within
# 1e-4 relative, the parameters by its rule (every element within two
# learning rates a step, all but 0.1% outside the key biases within 1e-3 of
# the learning rate times the steps); AdamW's moments every element within
# 1e-3 of its tensor's largest outside the key biases (whose gradient is at
# the rounding level); the eval's metrics within EVAL_METRIC_REL_TOL. TP2's
# first loss within the JAX test_train_tensor_parallel_matches_dp's 1e-4.
TRAIN_PARALLEL_LOSS_REL_TOL = 1e-5
TRAIN_PARALLEL_GRAD_NORM_REL_TOL = 1e-4
TRAIN_TP_LOSS_REL_TOL = 1e-4
TRAIN_MOMENT_REL_TOL = 1e-3


def _scratch_path(path: str) -> bool:
    """A path a library writes on its own: the temp directory, /dev/null,
    the port's build caches."""
    import tempfile

    return path.startswith((tempfile.gettempdir(), os.devnull)) or "_build" in path


def train_parallel_child(out_dir: str, max_steps, argv) -> int:
    """One rank of a torchrun of `python -m d3roma_tpu_torch.train argv`
    (runpy, in this process; capped at TRAIN_PARALLEL_MEMORY_FRACTION of
    the card; `train` given `max_steps`, None for every epoch), recording
    to out_dir/rank<RANK>.json: each
    train step synchronized and timed with its loss, grad_norm and the
    collectives it made (calls, bytes, host seconds), the run's collectives,
    this rank's sharded parameters and optimizer tensors and their bytes,
    its peak memory, the hand kernels' launches, and every path it opened
    for writing or made (an audit hook)."""
    import runpy
    from functools import partial

    import torch

    from d3roma_tpu_torch import training
    from d3roma_tpu_torch.parallel import mesh as pmesh
    from d3roma_tpu_torch.parallel import param_bytes
    from d3roma_tpu_torch.training import train_loop

    rank = int(os.environ.get("RANK", "0"))
    record = dict(rank=rank, step_ms=[], loss=[], grad_norm=[], step_collectives=[],
                  step_peak_gib=[], wrote=[])
    recording = [True]

    def hook(event, args):
        if not recording[0]:
            return
        if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
            record["wrote"].append(str(args[0]))
        elif event in ("os.mkdir", "os.rename", "os.remove"):
            record["wrote"].append(str(args[0]))

    make_step = train_loop.make_train_step
    card = torch.cuda.is_available()

    def sync():
        if card:
            torch.cuda.synchronize()

    def make_timed(config, unet, optimizer, *args, **kw):
        step = make_step(config, unet, optimizer, *args, **kw)
        sharded = optimizer.sharded_counts()
        record.update(sharded_params=sharded[0], sharded_optimizer_tensors=sharded[1],
                      param_bytes=param_bytes(unet), whole_param_bytes=param_bytes(unet, True),
                      optimizer_bytes=optimizer.nbytes())

        def timed(state, batch, draws):
            sync()
            before = dict(pmesh.COLLECTIVES)
            t0 = time.perf_counter()
            out = step(state, batch, draws)
            sync()
            record["step_ms"].append((time.perf_counter() - t0) * 1e3)
            record["step_collectives"].append(
                {k: pmesh.COLLECTIVES[k] - before[k] for k in before})
            record["loss"].append(float(out["loss"]))
            record["grad_norm"].append(float(out["grad_norm"]))
            if card:  # the run's peak so far: the steps' against the rest's
                record["step_peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            return out

        return timed

    train_loop.make_train_step = make_timed
    training.train = partial(training.train, max_steps=max_steps)
    if card:
        torch.cuda.set_per_process_memory_fraction(TRAIN_PARALLEL_MEMORY_FRACTION)
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    sys.addaudithook(hook)
    sys.argv = ["d3roma_tpu_torch.train"] + list(argv)
    rc = 0
    try:
        runpy.run_module("d3roma_tpu_torch.train", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code or 0
    recording[0] = False
    record.update(launches=_int8_launches(), collectives=dict(pmesh.COLLECTIVES),
                  peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return int(rc)


def _parallel_start(tmp: str, repo: str, name: str, extra=(), max_steps=None,
                    child="--train-parallel-rank"):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2` of
    the train entry point (each rank through `train_parallel_child`, by
    `child`'s flag, which stops it after `max_steps` when given) with the
    train phase's arguments, one epoch, output in tmp/name (`extra` after
    them).
    Returns (process, start time); the process leads its own session, so a
    timeout kills torchrun and its ranks together."""
    records = os.path.join(tmp, f"{name}_records")
    os.makedirs(records, exist_ok=True)
    out = open(os.path.join(tmp, f"{name}.out"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={TRAIN_PARALLEL_RANKS}", os.path.join(repo, "chip_smoke.py"),
         child, records, str(max_steps or 0), f"task={TRAIN_PRESET}"]
        + TRAIN_ARGS + ["task.num_epochs=1", f"task.output_dir={name}"] + list(extra),
        cwd=tmp, stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    out.close()
    return proc, time.perf_counter()


def _kill_session(proc) -> None:
    """Kill a child that leads its session, and its session (torchrun's
    ranks)."""
    import signal

    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _wait_or_kill(proc, timeout: float, label: str, out_path: str) -> float:
    """Wait for a child that leads its session; on the timeout kill the
    session and fail. Returns its exit code."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_session(proc)
        with open(out_path) as f:
            raise AssertionError(f"{label}: no end in {timeout} s (a rank hung?)\n"
                                 f"{f.read()[-4000:]}")


def _parallel_finish(tmp: str, name: str, proc, t0: float):
    """Wait for a torchrun; fail on a non-zero exit. Returns (the ranks'
    records, rank 0's train.log, wall seconds)."""
    out_path = os.path.join(tmp, f"{name}.out")
    rc = _wait_or_kill(proc, TRAIN_PARALLEL_TIMEOUT, name, out_path)
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(out_path) as f:
            raise AssertionError(f"{name}: torchrun failed ({rc}):\n{f.read()[-6000:]}")
    records = []
    for r in range(TRAIN_PARALLEL_RANKS):
        with open(os.path.join(tmp, f"{name}_records", f"rank{r}.json")) as f:
            records.append(json.load(f))
    with open(os.path.join(tmp, name, "train.log")) as f:
        return records, f.read(), wall


def _logged_eval(log: str, step: int) -> dict:
    """The metrics dict of the `eval[0] @step:` line of a train.log."""
    import ast

    key = f"eval[0] @{step}: "
    line = next(l for l in log.splitlines() if key in l)
    return ast.literal_eval(line.split(key, 1)[1])


def _state_agreement(ours, ref, lr: float, steps: int, device: str = "cuda") -> dict:
    """Two train states (state dicts, or paths of state.pt, loaded with
    mmap) compared tensor by tensor on the card: the parameters' largest
    |difference| and the share of elements outside the key biases over
    1e-3 of the learning rate times the steps; each AdamW moment's largest
    |difference| over its tensor's largest |value| outside the key biases.
    Raises unless the parameters keep TRAIN_* rule and the moments
    TRAIN_MOMENT_REL_TOL."""
    import torch

    def load(s):
        return s if isinstance(s, dict) else torch.load(s, map_location="cpu", weights_only=True,
                                                        mmap=True)

    def on(t):
        return t.to(device).float()

    a, b = load(ours), load(ref)
    names = list(b["params"])
    if list(a["params"]) != names:
        raise AssertionError("the two states name other parameters")
    worst, over, total = 0.0, 0, 0
    bound = 1e-3 * lr * steps
    for k in names:
        d = (on(a["params"][k]) - on(b["params"][k])).abs()
        worst = max(worst, float(d.max()))
        if not k.endswith("to_k.bias"):
            over += int((d > bound).sum())
            total += d.numel()
    moments = {}
    for key in ("mu", "nu"):
        ta, tb = a["opt_state"][key], b["opt_state"][key]
        if len(ta) != len(tb) or len(tb) != len(names):
            raise AssertionError(f"{key}: {len(ta)} / {len(tb)} tensors for {len(names)} params")
        rel = 0.0
        for k, x, y in zip(names, ta, tb):
            if tuple(x.shape) != tuple(y.shape):
                raise AssertionError(f"{key} {k}: shapes {tuple(x.shape)} / {tuple(y.shape)}")
            if k.endswith("to_k.bias"):
                continue
            y = on(y)
            d = (on(x) - y).abs().max()
            rel = max(rel, float(d / y.abs().max().clamp_min(1e-30)))
        moments[key] = rel
    out = dict(params_max_abs=worst, params_share_over=over / max(total, 1),
               moments_max_rel=moments, lr=lr, steps=steps)
    if (worst > 2 * lr * steps or over > 1e-3 * total
            or max(moments.values()) > TRAIN_MOMENT_REL_TOL):
        raise AssertionError(f"train states disagree: {out}")
    return out


def first_epoch_child(tp2_run: str, out_path: str, argv) -> int:
    """`python -m d3roma_tpu_torch.train argv` (runpy, in this process)
    keeping its train state after the first step in host memory (the
    one-process layout); once the run ends and the TP2 run in `tp2_run` has
    written its gathered step-1 checkpoint, that state loaded here and held
    to it by `_state_agreement`, the result written to out_path (no second
    copy of a state on the disk: the machine's disk is bounded). Waits at
    most TRAIN_PARALLEL_TIMEOUT s, less if `tp2_run` + ".failed" appears."""
    import runpy

    import torch

    from d3roma_tpu_torch.training import train_loop

    make_step = train_loop.make_train_step
    kept = {}

    def make_keeping(config, *args, **kw):
        step = make_step(config, *args, **kw)

        def keeping(state, batch, draws):
            out = step(state, batch, draws)
            if not kept:
                sd = state.state_dict()
                kept.update(lr=config.learning_rate, state={
                    "params": {k: v.detach().cpu().clone() for k, v in sd["params"].items()},
                    "opt_state": {k: [t.detach().cpu().clone() for t in sd["opt_state"][k]]
                                  for k in ("mu", "nu")}})
            return out

        return keeping

    train_loop.make_train_step = make_keeping
    sys.argv = ["d3roma_tpu_torch.train"] + list(argv)
    rc = 0
    try:
        runpy.run_module("d3roma_tpu_torch.train", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = int(e.code or 0)
    if rc or not kept:
        return rc or 1
    done = os.path.join(tp2_run, "checkpoints", "last", "counter.json")
    deadline = time.perf_counter() + TRAIN_PARALLEL_TIMEOUT
    while not os.path.exists(done):
        if os.path.exists(tp2_run + ".failed") or time.perf_counter() > deadline:
            print("first epoch: no TP2 checkpoint to compare", flush=True)
            return 1
        time.sleep(0.5)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    agreement = _state_agreement(os.path.join(tp2_run, "checkpoints", "last", "state.pt"),
                                 kept["state"], kept["lr"], 1,
                                 "cuda" if torch.cuda.is_available() else "cpu")
    with open(out_path, "w") as f:
        json.dump(agreement, f)
    return 0


def _rank_summary(records, global_batch: int, steady: slice) -> dict:
    """Each rank's ms/step (the median of the `steady` steps), samples/s of
    the global batch, peak memory, collectives a step and its bytes."""
    out = []
    for rec in records:
        ms = statistics.median(rec["step_ms"][steady])
        out.append(dict(rank=rec["rank"], step_ms=rec["step_ms"], ms_per_step=ms,
                        samples_per_s=global_batch / ms * 1e3,
                        peak_memory_gib=rec["peak_memory_gib"],
                        step_peak_gib=rec["step_peak_gib"],
                        step_collectives=rec["step_collectives"],
                        run_collectives=rec["collectives"], param_bytes=rec["param_bytes"],
                        whole_param_bytes=rec["whole_param_bytes"],
                        optimizer_bytes=rec["optimizer_bytes"],
                        sharded_params=rec["sharded_params"],
                        sharded_optimizer_tensors=rec["sharded_optimizer_tensors"]))
    return out


class TrainParallel:
    """The train phase's multi-rank runs, on a thread beside the one-process
    work: `python -m torch.distributed.run --standalone --nproc-per-node 2
    -m d3roma_tpu_torch.train` (through `train_parallel_child`) with the
    train phase's arguments, both ranks on the one card over gloo. Their
    reference is the train phase's one-process first epoch (the same
    frames, seed and epoch). The card's memory sets the order (TP2's two
    ranks take ~49 GiB, DP2's ~34, the first epoch ~23, the resumed run
    ~16, the accuracy phase's int8 checks ~25), and the machine's disk
    (45 GiB written at most; a train state is 10.4 GB) keeps every reference
    state in host memory and each run's outputs only until they are
    checked:

    - TP2 (task.tensor_parallel=2, dp 1, global batch 16 on each rank) starts
      with the frames, beside the eval phase and the first epoch; cut to
      one step (`train(max_steps=1)`: no eval, no epoch export; checkpoints/last
      holds the gathered step-1 state). Held to the first epoch's logged
      step-1 loss, and its state, loaded in the first epoch's process once
      that run ends, to that run's step-1 state (`first_epoch_child`).
      Both ranks shard parameters and moments.
    - DP2 (3 steps of global batch 16, 8 rows a rank, the eval at step 3)
      starts when TP2 ends, beside the first epoch and the resumed run.
      Held to the first epoch: every step's loss and grad_norm,
      checkpoints/last's parameters and AdamW moments (the one-process
      step-3 state, read into host memory before the resumed run replaces
      it), the eval's depth/rel and disp/epe, rank 1 wrote nothing, rank 0
      the one-process run's files."""

    def __init__(self, tmp: str, repo: str, device: str = "cuda"):
        """Start TP2 (the train frames must be in `tmp`)."""
        import threading

        from d3roma_tpu_torch.config import compose

        self.tmp, self.repo, self.device = tmp, repo, device
        # the entry point's device flag (the CUDA default needs none)
        self.flags = [] if device == "cuda" else ["--device", device]
        self.lr = compose([f"task={TRAIN_PRESET}"]).task.learning_rate
        self.tp2_run = os.path.join(tmp, "run_tp2")
        # (the TP2 run, the first epoch's file of its agreement with it)
        self.first_epoch_args = (self.tp2_run, os.path.join(tmp, "tp2_agreement.json"))
        self.first_epoch = threading.Event()
        self.one = {}
        self.tp2 = _parallel_start(tmp, repo, "run_tp2", ["task.tensor_parallel=2"] + self.flags,
                                   max_steps=1)
        self.side = _Beside(self._run)

    def first_epoch_done(self, run: str) -> None:
        """Keep the one-process step-3 state (read into host memory on a
        thread, long before the resumed run replaces state.pt at its end)
        and log (the resumed run appends to train.log)."""
        from functools import partial

        import torch

        state = _Beside(partial(torch.load, os.path.join(run, "checkpoints", "last", "state.pt"),
                                map_location="cpu", weights_only=True))
        with open(os.path.join(run, "train.log")) as f:
            self.one = dict(state=state, log=f.read())
        self.first_epoch.set()

    def result(self) -> dict:
        """Join the runs (after a failure of the first epoch, nothing more
        starts)."""
        self.first_epoch.set()
        return self.side.result()

    def _run(self) -> dict:
        dp2_run = None
        try:
            try:
                records, log, wall = _parallel_finish(self.tmp, "run_tp2", *self.tp2)
            except BaseException:
                open(self.tp2_run + ".failed", "w").close()  # the first epoch stops waiting
                raise
            dp2_run = _parallel_start(self.tmp, self.repo, "run_dp2", self.flags)
            self.first_epoch.wait()
            if not self.one:
                raise AssertionError("train: the one-process first epoch failed")
            tp2 = self._check_tp2(records, log, wall)
        except BaseException:
            if dp2_run is not None:
                _kill_session(dp2_run[0])
            raise
        finally:
            shutil.rmtree(self.tp2_run, ignore_errors=True)
        try:
            records, log, wall = _parallel_finish(self.tmp, "run_dp2", *dp2_run)
            dp2 = self._check_dp2(records, log, wall)
        finally:
            shutil.rmtree(os.path.join(self.tmp, "run_dp2"), ignore_errors=True)
            self.one.pop("state", None)
        return dict(dp2=dp2, tp2=tp2)

    def _common(self, label, records, log):
        """Finite steps on every rank, the same on both, no hand kernel,
        rank 1 wrote nothing; rank 0's mesh line."""
        import math

        for rec in records:
            if rec["launches"] and any(rec["launches"].values()):
                raise AssertionError(f"{label}: hand kernels launched: {rec['launches']}")
            if not all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"]):
                raise AssertionError(f"{label}: rank {rec['rank']} non-finite steps")
        if records[0]["loss"] != records[1]["loss"]:
            raise AssertionError(f"{label}: the ranks' losses differ {records[0]['loss']} "
                                 f"{records[1]['loss']}")
        wrote = [w for w in records[1]["wrote"] if not _scratch_path(w)]
        if wrote:
            raise AssertionError(f"{label}: rank 1 wrote {wrote[:10]}")
        if "backend gloo" not in log:
            raise AssertionError(f"{label}: no gloo mesh line in train.log\n{log[-2000:]}")

    def _check_dp2(self, records, log, wall) -> dict:
        self._common("DP2", records, log)
        one_steps = _logged_steps(self.one["log"])[:3]
        dp_steps = _logged_steps(log)
        rel = []
        for (s1, l1, g1), (s2, l2, g2) in zip(one_steps, dp_steps):
            rel.append((s1, abs(l2 - l1) / abs(l1), abs(g2 - g1) / abs(g1)))
        if ([s for s, _, _ in dp_steps] != [1, 2, 3]
                or max(r[1] for r in rel) > TRAIN_PARALLEL_LOSS_REL_TOL
                or max(r[2] for r in rel) > TRAIN_PARALLEL_GRAD_NORM_REL_TOL):
            raise AssertionError(f"DP2 steps {dp_steps} against one process {one_steps}")
        run = os.path.join(self.tmp, "run_dp2")
        agreement = _state_agreement(os.path.join(run, "checkpoints", "last", "state.pt"),
                                     self.one["state"].result(), self.lr, 3, self.device)
        ours, ref = _logged_eval(log, 3), _logged_eval(self.one["log"], 3)
        eval_rel = {k: abs(ours[g][m] - ref[g][m]) / abs(ref[g][m])
                    for k, (g, m) in {"depth/rel": ("depth", "rel"),
                                      "disp/epe": ("disp", "epe")}.items()}
        if max(eval_rel.values()) > EVAL_METRIC_REL_TOL:
            raise AssertionError(f"DP2 eval {ours} against one process {ref}")
        for name in ("checkpoints/last/state.pt", "checkpoints/last/counter.json",
                     "best/model_index.json", "epoch_0000/unet/params.msgpack",
                     "epoch_0000/vae/params.msgpack"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"DP2: rank 0 wrote no {name}")
        ranks = _rank_summary(records, TRAIN_BATCH, slice(1, None))
        summary = dict(wall_s=wall, steps=dp_steps, rel_to_one_process=rel, state=agreement,
                       eval_rel=eval_rel, ranks=ranks, rank1_wrote=[])
        print(f"train DP2 (2 ranks, gloo, one card): {wall:.1f}s; steps {dp_steps}; against one "
              f"process: loss / grad_norm rel {[(s, f'{l:.1e}', f'{g:.1e}') for s, l, g in rel]} "
              f"(tol {TRAIN_PARALLEL_LOSS_REL_TOL} / {TRAIN_PARALLEL_GRAD_NORM_REL_TOL}); "
              f"step-3 state {agreement}; eval rel {eval_rel} (tol {EVAL_METRIC_REL_TOL}); rank 1 "
              f"wrote nothing", flush=True)
        for r in ranks:
            c = r["step_collectives"][-1]
            print(f"  DP2 rank {r['rank']}: {r['ms_per_step']:.1f} ms/step (median of steps 2-3; "
                  f"steps {[round(x, 1) for x in r['step_ms']]}), {r['samples_per_s']:.2f} "
                  f"samples/s, peak {r['peak_memory_gib']:.2f} GiB (after each step "
                  f"{[round(x, 2) for x in r['step_peak_gib']]}); a step's collectives "
                  f"{c['calls']} calls, {c['bytes'] / 2**20:.1f} MiB, {c['seconds']:.3f} s host; "
                  f"parameter bytes {r['param_bytes']}, optimizer bytes {r['optimizer_bytes']}",
                  flush=True)
        return summary

    def _check_tp2(self, records, log, wall) -> dict:
        self._common("TP2", records, log)
        steps = _logged_steps(log)
        one = _logged_steps(self.one["log"])[0]
        loss_rel = abs(steps[0][1] - one[1]) / abs(one[1]) if steps else float("inf")
        grad_rel = abs(steps[0][2] - one[2]) / abs(one[2]) if steps else float("inf")
        if [s for s, _, _ in steps] != [1] or loss_rel > TRAIN_TP_LOSS_REL_TOL:
            raise AssertionError(f"TP2 step {steps} against one process {one}")
        for rec in records:
            if not (rec["sharded_params"] > 0 and rec["sharded_optimizer_tensors"] > 0):
                raise AssertionError(f"TP2 rank {rec['rank']} shards nothing: {rec}")
        with open(self.first_epoch_args[1]) as f:
            agreement = json.load(f)
        ranks = _rank_summary(records, TRAIN_BATCH, slice(0, 1))
        summary = dict(wall_s=wall, steps=steps, loss_rel_to_first_epoch=loss_rel,
                       grad_norm_rel_to_first_epoch=grad_rel, state=agreement, ranks=ranks,
                       rank1_wrote=[])
        print(f"train TP2 (2 ranks, gloo, one card; cut to 1 step): {wall:.1f}s; step {steps}; "
              f"against the first epoch's step 1: loss rel {loss_rel:.2e} (tol "
              f"{TRAIN_TP_LOSS_REL_TOL}), grad_norm rel {grad_rel:.2e}; the gathered step-1 "
              f"state in one process against that run's {agreement}; rank 1 wrote nothing",
              flush=True)
        for r in ranks:
            c = r["step_collectives"][0]
            print(f"  TP2 rank {r['rank']}: step {r['ms_per_step']:.1f} ms (a fresh process's "
                  f"first), {r['samples_per_s']:.2f} samples/s, peak {r['peak_memory_gib']:.2f} "
                  f"GiB (after the step {[round(x, 2) for x in r['step_peak_gib']]}); the "
                  f"step's collectives {c['calls']} calls, {c['bytes'] / 2**30:.2f} GiB, "
                  f"{c['seconds']:.1f} s host; the run's {r['run_collectives']}; "
                  f"{r['sharded_params']} sharded parameters, {r['sharded_optimizer_tensors']} "
                  f"sharded optimizer tensors; parameter bytes {r['param_bytes']} of "
                  f"{r['whole_param_bytes']}, optimizer bytes {r['optimizer_bytes']}", flush=True)
        return summary


def train_parallel_phase(tmp: str) -> dict:
    """`python3 chip_smoke.py --train-parallel`: the train phase's frames,
    TP2 beside the one-process first epoch (which keeps its step-1 state),
    then DP2 (`TrainParallel`)."""
    parallel = train_parallel_start(tmp)
    try:
        run, first = _first_epoch(tmp, os.path.dirname(os.path.abspath(__file__)),
                                  frames=False, tp2=parallel.first_epoch_args)
        parallel.first_epoch_done(run)
    finally:
        out = parallel.result()  # after a failure, ends the runs it started
    return dict(out, epoch_1=first)


def train_parallel_start(tmp: str) -> "TrainParallel":
    """The train phase's frames in `tmp`, then the multi-rank runs started."""
    _write_train_frames(tmp)
    return TrainParallel(tmp, os.path.dirname(os.path.abspath(__file__)))


def train_parallel_join(parallel) -> dict:
    """Wait for the train phase's multi-rank runs (`TrainParallel`)."""
    return parallel.result()


TRAIN_TP_FF_STEPS = 2  # the second, warm, step is the one compared


def train_tp_ff_phase(tmp: str) -> dict:
    """`python3 chip_smoke.py --train-tp-ff`: the TP2 train run (two ranks,
    gloo, one card; the train phase's arguments, TRAIN_TP_FF_STEPS steps)
    with every unquantized feed-forward on each rank's chunk of the hidden
    width (`FeedForward._inline`, the port's path), then with the
    projection gathered (the unfused sharded dense layers: the ranks make
    `FeedForward._paired_shards` false), one after the other: each run's
    ms a step, collectives a step (calls, bytes, host seconds) and peak
    memory a rank; both runs' losses within TRAIN_TP_LOSS_REL_TOL of each
    other."""
    _write_train_frames(tmp)
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for variant, child in (("chunked", "--train-parallel-rank"),
                           ("gathered", "--train-parallel-rank-gathered-ff")):
        name = f"run_ff_{variant}"
        proc, t0 = _parallel_start(tmp, repo, name, ["task.tensor_parallel=2"],
                                   TRAIN_TP_FF_STEPS, child)
        try:
            records, log, wall = _parallel_finish(tmp, name, proc, t0)
        finally:
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
        ranks = _rank_summary(records, TRAIN_BATCH, slice(1, None))
        out[variant] = dict(wall_s=wall, loss=records[0]["loss"], ranks=ranks)
        for r in ranks:
            c = r["step_collectives"][-1]
            print(f"train TP2, feed-forward {variant}: rank {r['rank']} steps "
                  f"{[round(x, 1) for x in r['step_ms']]} ms, peak {r['peak_memory_gib']:.2f} GiB; "
                  f"step {TRAIN_TP_FF_STEPS}'s collectives {c['calls']} calls, "
                  f"{c['bytes'] / 2**30:.3f} GiB, {c['seconds']:.2f} s host; the run {wall:.1f} s",
                  flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["chunked"]["loss"], out["gathered"]["loss"])]
    if len(rel) != TRAIN_TP_FF_STEPS or max(rel) > TRAIN_TP_LOSS_REL_TOL:
        raise AssertionError(f"train TP2 feed-forward: losses {out}")
    out["loss_rel"] = rel
    return out


def train_timings() -> tuple:
    """The full-width step timed in fp32 and in bf16 compute over fp32
    parameters (`train_timing`), once the multi-rank runs have ended."""
    from d3roma_tpu_torch.config import compose

    fp32 = train_timing(compose([f"task={TRAIN_PRESET}"]).task)
    return fp32, train_timing(compose([f"task={TRAIN_PRESET}", "task.mixed_precision=bf16"]).task)


ACCURACY_FRAMES = 4  # one batch a row (8 before the mono phase: the pass's time limit)
ACCURACY_BATCH = 4
ACCURACY_KS = ("1", "2d2")
ACCURACY_MODES = ("bf16", "int8")
# a call's int8 attention and GEGLU launches in the int8 rows at the eval's
# 184x320 (latent 23x40), per denoise step: the 920-token level's 5
# self-attention sites in every UNet pass (the 240-token level runs plain;
# 2d2's shallow passes refresh the whole level), and 16 transformer blocks
# a full pass, 10 a depth-2 shallow one (5 full and 5 shallow steps under
# 2d2: 13 a step); plus the VAE's two mid attentions (one stacked encode,
# one stacked decode)
ACCURACY_ATTENTION_SITES = 5
ACCURACY_GEGLU_PER_STEP = {"1": 16, "2d2": 13}


def accuracy_phase(train_tmp=None, timing=True):
    """bf16 training and the DeepCache accuracy sweep on its checkpoint:

    - with `timing`, the full-width step in bf16 compute over fp32
      parameters (`train_timing` with task.mixed_precision=bf16) beside the
      fp32 one: ms/step, samples/s, peak memory, idle share, losses finite,
      no hand kernel launched (the whole pass times it in `train_timings`,
      alone on the card);
    - `d3roma_tpu_torch.deepcache_accuracy` in process on the train phase's
      bf16 checkpoint (`train_tmp`; alone, one bf16 epoch of the train entry
      point from random weights): ACCURACY_FRAMES procedural val frames at
      batch ACCURACY_BATCH, the rows ACCURACY_MODES x ACCURACY_KS, each on
      its own copy of the loaded pipeline; the table built with its drift
      columns, every metric finite; the launches of one call of each int8
      row (rows 1b, 2b, 3 and the quantize: 5 x 10 + 2 int8 attention and
      16 x 10 int8 GEGLU a call without DeepCache, fewer GEGLU under 2d2's shallow
      passes, one int8 conv and one quantize per conv and dense visit;
      ACCURACY_ATTENTION_SITES, ACCURACY_GEGLU_PER_STEP);
    - the int8:1 row's first batch of predictions through the kernels
      against the same batch with the conv, GEGLU and quantize kernels'
      plain versions (bit-equal kernels, the int8 attention kernel kept on
      both sides: bit-equal), and against the same batch through every
      plain version (the serve phase's int8 rule: within twice the int8
      noise, the plain int8 batch against the bf16:1 row's, which runs no
      kernel; the plain batch on other noise must fall outside).

    Returns a summary dict."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from d3roma_tpu_torch import deepcache_accuracy as dca
    from d3roma_tpu_torch.config import compose

    summary = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    if timing:
        summary["bf16_step"] = train_timing(compose([f"task={TRAIN_PRESET}",
                                                     "task.mixed_precision=bf16"]).task)
    own = None
    if train_tmp is None:
        own = tempfile.mkdtemp()
        run, _ = _first_epoch(own, repo, ["task.mixed_precision=bf16"])
        checked = _fp32_checkpoint_and_export(run, os.path.join(run, "epoch_0000"))
        print(f"accuracy: the bf16 epoch's state.pt and epoch_0000/ fp32 ({checked})",
              flush=True)
    else:
        run = os.path.join(train_tmp, "run")
    try:
        # the sweep's layout: frames under <dir>/datasets, the checkpoint
        # under <dir>/run/checkpoints/last
        work = os.path.dirname(run)
        t0 = time.perf_counter()
        dca.data(work, ACCURACY_FRAMES)
        sweep = dca.Sweep.from_checkpoint(work, ACCURACY_FRAMES, ACCURACY_BATCH, "cuda")
        print(f"accuracy: checkpoint at step {sweep.step} loaded, {ACCURACY_FRAMES} val frames "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)
        calls = ACCURACY_FRAMES // ACCURACY_BATCH
        results, launches, preds, row_s = {}, {}, {}, {}
        for mode, k in dca.wanted_rows(ACCURACY_MODES, ACCURACY_KS):
            pipe = sweep.pipeline(mode, k)
            _zero_launches()
            t0 = time.perf_counter()
            m, preds[(mode, k)] = _predictions(lambda: sweep.evaluate(pipe))
            _sync()
            row_s[f"{mode}:{k}"] = round(time.perf_counter() - t0, 2)
            counts = {n: c for n, c in _int8_launches().items() if c}
            if mode == "bf16" and counts:
                raise AssertionError(f"accuracy: the bf16 row {k} launched {counts}")
            if mode == "int8":
                if any(c % calls for c in counts.values()):
                    raise AssertionError(f"accuracy: int8 {k} launches {counts} over {calls}")
                launches[k] = one = {n: c // calls for n, c in counts.items()}
                steps = sweep.config.num_inference_timesteps
                want = {"attention_int8": ACCURACY_ATTENTION_SITES * steps + 2,
                        "geglu_int8": ACCURACY_GEGLU_PER_STEP[k] * steps}
                if (any(one.get(n) != v for n, v in want.items()) or not one.get("conv2d_int8")
                        or one["quantize"] != one["conv2d_int8"] + one["geglu_int8"]):
                    raise AssertionError(f"accuracy: int8 {k} launches a call {one} (want {want}"
                                         f", one quantize a conv and a GEGLU)")
            m = {sp: {n: float(v) for n, v in d.items()} for sp, d in m.items()}
            m.update(_checkpoint_step=sweep.step, _device=dca.device_label("cuda"))
            results[(mode, k)] = m
            if mode == "int8" and k == "1":
                int8_pipe = pipe
            else:
                del pipe
        doc = dca.build_doc(results, ACCURACY_KS, ACCURACY_MODES, ACCURACY_FRAMES,
                            sweep.config.num_inference_timesteps)
        bad = [(sec, k, n) for sec in ("bf16", "combined_int8") for k, row in doc[sec].items()
               for n, v in row.items() if not math.isfinite(v)]
        drift = [(sec, k) for sec in ("bf16", "combined_int8") for k in doc[sec]
                 if (sec, k) != ("bf16", "1") and "depth_rel_drift_pct" not in doc[sec][k]]
        if bad or drift or "depth_rel_drift_pct_vs_int8" not in doc["combined_int8"]["2d2"]:
            raise AssertionError(f"accuracy: table not finite {bad} or drifts missing {drift}")
        print(f"accuracy: table {json.dumps(doc)}", flush=True)
        print(f"accuracy: seconds a row {row_s}; int8 launches a call {launches}", flush=True)

        # the int8:1 row's first batch with the bit-equal kernels' plain
        # versions (the int8 attention kernel on both sides): bit-equal
        _, same_preds = _predictions(lambda: _plain_int8_forward(
            lambda: sweep.evaluate(int8_pipe, max_batches=1), attention=False))
        exact = float(max(np.abs(a - b).max() for a, b in zip(preds[("int8", "1")][:1],
                                                               same_preds)))
        print(f"accuracy: int8:1 first batch's predictions through the kernels against the "
              f"conv, GEGLU and quantize kernels' plain versions: max |a - b| = {exact} (must "
              f"be 0)", flush=True)
        if len(same_preds) != 1 or exact != 0.0:
            raise AssertionError(f"accuracy: bit-equal kernels differ by {exact}")
        # the same batch through every plain version, and the yardstick
        _, ref_preds = _predictions(lambda: _plain_int8_forward(
            lambda: sweep.evaluate(int8_pipe, max_batches=1)))
        noise = _pred_rel(ref_preds, preds[("bf16", "1")][:1])
        _, control = _predictions(lambda: _plain_int8_forward(
            lambda: sweep.evaluate(int8_pipe, seed=dca.EVAL_SEED + 1, max_batches=1)))
        rel, control_rel = (_pred_rel(preds[("int8", "1")][:1], ref_preds),
                            _pred_rel(control, ref_preds))
        tol = 2 * noise
        print(f"accuracy: int8:1 first batch's predictions through the kernels against every "
              f"plain version max |a - b| / max |b| = {rel:.3e} (tol {tol:.3e}, twice the int8 "
              f"noise: the plain int8 batch against the bf16 row's {noise:.3e}); plain on other "
              f"noise {control_rel:.3e} (must exceed the tol)", flush=True)
        if not rel <= tol < control_rel:
            raise AssertionError(f"accuracy: kernels against plain {rel}, control {control_rel} "
                                 f"(tol {tol})")
        summary.update(checkpoint_step=sweep.step, table=doc, launches=launches,
                       row_seconds=row_s, int8_noise=noise, bit_equal_kernels=exact,
                       kernels_vs_plain=rel,
                       control=control_rel)
        del sweep, int8_pipe
        torch.cuda.empty_cache()
    finally:
        if own:
            shutil.rmtree(own, ignore_errors=True)
    return summary


SERVE_PRESET = "eval_ldm_mixed_rgb+raw"
SERVE_BATCH = 4  # the server's --max-batch and the in-process batched call
SERVE_HW = (360, 640)
# the in-process checks: the depth through the kernels against the same call
# through their plain versions, compared as disparity (fxb / depth, the
# model's own space, bounded by the normalizer's 128), max |a - b| / max |b|;
# the same call on other noise must fall outside the limit. The bf16 calls
# (latency): the eval phase's limit for a prediction after 10 steps. The
# int8 call (throughput): the conv, GEGLU and quantize kernels are bit-equal
# to their plain versions, so with the int8 attention kernel on both sides
# the call must be bit-equal; with every plain version the attention's one
# bf16 rounding (REL_TOL) flips int8 quanta downstream, so the limit is
# twice the int8 noise, taken from sides that hold no kernel under test: the
# call through every plain version against the same call in bf16 (latency,
# the same weights and noise) through every plain version
SERVE_PRED_REL_TOL = EVAL_PRED_REL_TOL
# the server's frames: depth ramps (0.8-1.2 x the scale, the SSI window must
# not be constant) at these scales in meters, two at 480x848
SERVE_SCALES = (0.4, 1.0, 2.5, 4.0, 0.4, 1.0, 2.5, 4.0)
SERVE_BIG = (5, 7)  # indexes of the 480x848 frames


def _serve_frame(seed, scale, hw=SERVE_HW):
    import numpy as np

    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    ramp = np.linspace(0.8, 1.2, hw[0] * hw[1]).reshape(hw).astype(np.float32)
    return rgb, (scale * ramp).astype(np.float32)


def _disparity(depth, fxb):
    import numpy as np

    d = np.asarray(depth, np.float64)
    return np.where(d > 0, fxb / np.maximum(d, 1e-12), 0.0)


def _depth_rel(ours, ref, fxb):
    """max |a - b| / max |b| over the frames' disparities."""
    import numpy as np

    a = np.stack([_disparity(d, fxb) for d in ours])
    b = np.stack([_disparity(d, fxb) for d in ref])
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _serve_counts(label, fn, expected):
    """fn() once with the launch counts zeroed; check them; returns the
    counts read, those above 0."""
    _zero_launches()
    fn()
    _sync()
    counts = _int8_launches()
    _check_counts(label, counts, expected)
    return {k: v for k, v in counts.items() if v}


def _kernel_vs_plain(label, droma, fn, plain, seed, fxb, tol=SERVE_PRED_REL_TOL, fast=None,
                     ref=None):
    """fn() through the kernels (or `fast`, its result on `seed`) and
    through `plain` (or `ref`, its result on `seed`), each from the
    generator seeded with `seed`, within `tol`; the plain run on seed + 1
    must fall outside it. Returns (rel, control rel)."""
    import numpy as np

    if fast is None:
        droma._generator.manual_seed(seed)
        fast = fn()
    if ref is None:
        droma._generator.manual_seed(seed)
        ref = plain(fn)
    droma._generator.manual_seed(seed + 1)
    control = plain(fn)
    fast, ref, control = ([x] if isinstance(x, np.ndarray) else x for x in (fast, ref, control))
    if not all(np.isfinite(d).all() for d in fast):
        raise AssertionError(f"{label}: non-finite depth through the kernels")
    rel, control_rel = _depth_rel(fast, ref, fxb), _depth_rel(control, ref, fxb)
    print(f"{label}: depth (as disparity) kernels against plain max |a - b| / max |b| = "
          f"{rel:.3e} (tol {tol:.3e}); plain on other noise {control_rel:.3e} "
          f"(must exceed the tol)", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{label}: kernels against plain {rel} (tol {tol})")
    if not control_rel > tol:
        raise AssertionError(f"{label}: other noise within the tolerance ({control_rel})")
    return rel, control_rel


def _median_ms(fn, frames, reps=2):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync()
        walls.append((time.perf_counter() - t0) * 1e3 / frames)
    return statistics.median(walls), walls


def _http(port, path, body=None, timeout=120):
    """(status, bytes) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve_demo(tmp, repo, pipe_dir):
    """`python -m d3roma_tpu_torch.demo` in its own process: the four
    artifacts read back, the depth finite, the clouds non-empty."""
    import numpy as np

    from d3roma_tpu_torch.utils.png import read_png
    from d3roma_tpu_torch.utils.pointcloud import read_ply

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "d3roma_tpu_torch.demo", "--variant", "rgb+raw",
         "--pretrained", pipe_dir, "task.fast_inference=latency"],
        cwd=tmp, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve: demo failed ({proc.returncode}): {proc.stderr[-3000:]}")
    out = os.path.join(tmp, "_outputs.rgb+raw")
    shapes = {}
    for name in ("raw_aligned.png", "pred.png"):
        img = read_png(os.path.join(out, name))
        if img.shape != SERVE_HW + (3,) or img.dtype != np.uint8:
            raise AssertionError(f"serve: demo {name} {img.shape} {img.dtype}")
        shapes[name] = list(img.shape)
    points = {}
    for name in ("raw.ply", "pred.ply"):
        pts, cols = read_ply(os.path.join(out, name))
        if not (len(pts) > 0 and np.isfinite(pts).all() and cols.shape == (len(pts), 3)):
            raise AssertionError(f"serve: demo {name}: {pts.shape}")
        points[name] = len(pts)
    # a cloud of finite points is a finite depth: pred.ply holds its pixels > 0
    print(f"serve: demo process exit 0 in {wall:.1f}s; {shapes}, points {points}", flush=True)
    return dict(wall_s=wall, points=points)


def _serve_server(tmp, repo, calib_dir):
    """`python -m d3roma_tpu_torch.serve` in its own process under SSI
    (least squares): ready after its warm frame, 8 concurrent requests
    (SERVE_SCALES, two at 480x848), each answer at its own frame's scale; a
    malformed one gets 400; /metrics; SIGTERM ends it with exit 0."""
    import io
    import json as _json
    import signal
    import threading

    import numpy as np

    from d3roma_tpu_torch.streaming.http_server import _npz_bytes

    out_path, err_path = os.path.join(tmp, "serve.out"), os.path.join(tmp, "serve.err")
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "d3roma_tpu_torch.serve", "--host", "127.0.0.1", "--port", "0",
             "--max-batch", str(SERVE_BATCH), "--", f"task={SERVE_PRESET}",
             "task.image_size=[360,640]", "task.num_intermediate_images=1",
             "task.fast_inference=throughput", "task.ssi=true", "task.safe_ssi=false",
             f"task.resume_pretrained={calib_dir}"],
            cwd=tmp, stdout=out_f, stderr=err_f,
            env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    summary = {}
    try:
        def log_tail():
            with open(err_path) as f:
                return f.read()[-3000:]

        port, deadline = None, time.monotonic() + 300
        while port is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"serve: server exited {proc.returncode}: {log_tail()}")
            with open(out_path) as f:
                for line in f:
                    if line.startswith("serving on http://127.0.0.1:"):
                        port = int(line.split(":")[2].split()[0])
            time.sleep(0.2)
        if port is None:
            raise AssertionError(f"serve: no port printed: {log_tail()}")
        health = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"serve: server exited {proc.returncode}: {log_tail()}")
            status, body = _http(port, "/healthz", timeout=10)
            if status == 200:
                health = _json.loads(body)
                break
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        if health is None or health.get("status") != "ok" or "warmup_error" in health:
            raise AssertionError(f"serve: not ready or warm-up failed: {health}; {log_tail()}")
        print(f"serve: server on port {port} ready in {ready_s:.1f}s (process start, load, "
              f"warm frame): {health}", flush=True)

        frames = [_serve_frame(100 + i, s, (480, 848) if i in SERVE_BIG else SERVE_HW)
                  for i, s in enumerate(SERVE_SCALES)]
        answers, lock = {}, threading.Lock()

        def call(i):
            rgb, raw = frames[i]
            t = time.perf_counter()
            got = _http(port, "/v1/infer_rgb_raw", _npz_bytes(rgb=rgb, raw_depth=raw),
                        timeout=300)
            with lock:
                answers[i] = got + ((time.perf_counter() - t) * 1e3,)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(frames))]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t1
        scales = sorted(set(SERVE_SCALES))
        medians = []
        for i, s in enumerate(SERVE_SCALES):
            status, body, ms = answers[i]
            if status != 200:
                raise AssertionError(f"serve: request {i} got {status}: {body[:300]}")
            depth = np.load(io.BytesIO(body))["depth"]
            if depth.dtype != np.float32 or depth.shape != SERVE_HW or not np.isfinite(depth).all():
                raise AssertionError(f"serve: request {i}: {depth.dtype} {depth.shape}")
            pos = depth[depth > 0]
            med = float(np.median(pos)) if pos.size else 0.0
            nearest = min(scales, key=lambda c: abs(np.log(max(med, 1e-9) / c)))
            medians.append((s, round(med, 4), round(pos.size / depth.size, 4), round(ms, 1)))
            if nearest != s:
                raise AssertionError(f"serve: request {i} at {s} m answered median {med} m")
        print(f"serve: 8 concurrent requests in {burst_s:.2f}s, each 200 with a finite float32 "
              f"{SERVE_HW} depth at its own scale (scale, median of depth > 0, share > 0, ms): "
              f"{medians}", flush=True)
        status, body = _http(port, "/metrics")
        metrics = _json.loads(body)
        print(f"serve: /metrics {metrics}", flush=True)
        if status != 200 or metrics["errors"] != 0 or metrics["batches"] < 2:
            raise AssertionError(f"serve: /metrics {metrics}")
        bad = _http(port, "/v1/infer_rgb_raw",
                    _npz_bytes(rgb=np.zeros((8, 8, 3), np.float32),
                               raw_depth=np.ones((8, 8), np.float32)))
        if bad[0] != 400:
            raise AssertionError(f"serve: a float rgb got {bad[0]}, not 400")
        print(f"serve: malformed request answered 400: {bad[1][:120]!r}", flush=True)
        summary = dict(ready_s=ready_s, burst_s=burst_s, answers=medians,
                       latency_ms=metrics.get("latency_ms"), batches=metrics["batches"],
                       padded_rows=metrics["padded_rows"])
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError("serve: the server did not exit within 60 s of SIGTERM")
    with open(out_path) as f:
        stopped = "server stopped" in f.read()
    print(f"serve: server process exit {rc} after SIGTERM (stopped cleanly: {stopped})",
          flush=True)
    if rc != 0 or not stopped:
        raise AssertionError(f"serve: server exit {rc}")
    return summary


def serve_latent_pipe(cfg, cond, gen):
    """The serve phase's full-width latent pipeline for the condition
    `cond`: SD2.1 geometry, random weights from `gen` in bf16, guidance
    weight 0, the normalizer and sampler of the preset `cfg`."""
    import torch

    from d3roma_tpu_torch.guidance import FlowGuidance
    from d3roma_tpu_torch.models import (
        AutoencoderKL,
        UNet2DCondition,
        init_random_,
        widened_in_channels,
    )
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec

    return GuidedLatentDiffusionPipeline(
        unet=init_random_(UNet2DCondition(in_channels=widened_in_channels(cond),
                                          out_channels=4, device="cuda"), gen),
        vae=init_random_(AutoencoderKL(device="cuda"), gen),
        text_embed=torch.zeros(1, 2, 1024), spec=create_sampler_spec(cfg, train=False),
        normalizer=Normalizer.from_config(cfg),
        guidance=FlowGuidance(flow_guidance_weight=0.0), device="cuda").half_precision()


def serve_phase():
    """Serving on the card, hermetic, in a temporary directory:

    - a full-width rgb+raw latent pipeline (SD2.1 geometry, seeded random
      weights in bf16, guidance weight 0, the preset's normalizer) saved
      with save_pretrained; a copy of the directory calibrated by `python -m
      d3roma_tpu_torch.calibrate_pipeline` in its own process
      (`calibrate_cli`: SERVE_BATCH procedural frames at 360x640, the
      preset's steps, act_scales.json written into the copy); a second UNet
      with the left+right+raw conv_in, in memory;
    - `python -m d3roma_tpu_torch.demo --variant rgb+raw --pretrained DIR
      task.fast_inference=latency` in its own process: its four artifacts
      read back (`utils/png.py`, `read_ply`), the clouds non-empty;
    - streaming/probe.py's `select_streaming_mode` at batch 1 on the saved
      directory, its records in a temporary file: it must pick "latency",
      the first candidate, with ok;
    - `python -m d3roma_tpu_torch.serve --port 0 --max-batch 4` on the
      calibrated directory under throughput and SSI least squares
      (`_serve_server`);
    - in process, `D3RoMa` on the calibrated directory under throughput:
      one infer_with_rgb_raw_batch call of SERVE_BATCH frames, its launch
      counts from the calibrated tables (102 int8 attention, 160 int8
      GEGLU, one int8 conv per conv or dense site visit, one quantize per
      int8 conv and GEGLU); the depth bit-equal to the same call with the
      conv, GEGLU and quantize kernels' plain versions, and within twice
      the int8 noise (the call through every plain version against the same
      call in bf16 through every plain version) of the call with every
      plain version (other noise outside); the upload, then pre, pipeline
      and post under set_sync_debug_mode("error"), then the copy; under latency,
      infer_with_rgb_raw (rgb+raw) and infer (left+right+raw) at batch 1
      against _plain_bf16, 100 attention and 160 GEGLU launches each, and
      the single-frame path under set_sync_debug_mode("error") too;
    - timings: ms/request of infer_with_rgb_raw at batch 1 (latency and
      throughput), ms/frame of the batched call, the host ms of the prep
      (resize, disparity, upload) and of the final copy, one profiled
      batched call's idle share, and the server's p50/p90/p99.

    Returns a summary dict."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from d3roma_tpu_torch.config import compose
    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.streaming.probe import select_streaming_mode
    from d3roma_tpu_torch.utils.camera import Realsense

    summary = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = compose([f"task={SERVE_PRESET}"]).task
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)  # D3RoMa writes _outputs.<variant>/ in the working directory
        try:
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(0)

            def latent_pipe(cond):
                return serve_latent_pipe(cfg, cond, gen)

            pipe = latent_pipe("rgb+raw")
            pipe_dir, calib_dir = os.path.join(tmp, "pipe"), os.path.join(tmp, "calib")
            pipe.save_pretrained(pipe_dir)
            del pipe
            torch.cuda.empty_cache()
            print(f"serve: pipeline built and saved in {time.perf_counter() - t0:.1f}s",
                  flush=True)
            # the calibrated directory: a copy calibrated by the entry point, on
            # SERVE_BATCH procedural frames at 360x640 and the preset's steps
            shutil.copytree(pipe_dir, calib_dir)
            frames = [_serve_frame(10 + i, s) for i, s in enumerate((0.5, 1.0, 2.0, 3.5))]

            # the calibration, the demo and the probe, each its own processes,
            # together (none is timed against another phase)
            probe_out, calib_out = {}, {}
            records = os.path.join(tmp, "probe.jsonl")

            def calibrate():
                try:
                    calib_out["result"] = calibrate_cli(tmp, repo, calib_dir, SERVE_BATCH,
                                                        cfg.num_inference_timesteps)
                except Exception as e:  # noqa: BLE001 - raised below
                    calib_out["error"] = e

            def probe():
                try:
                    probe_out["result"] = select_streaming_mode(
                        [f"task={SERVE_PRESET}", "task.image_size=[360,640]",
                         "task.num_intermediate_images=1", f"task.resume_pretrained={pipe_dir}"],
                        batch=1, timeout_s=600, records_path=records)
                except Exception as e:  # noqa: BLE001 - reported below
                    probe_out["error"] = repr(e)

            t0 = time.perf_counter()
            sides = [threading.Thread(target=probe), threading.Thread(target=calibrate)]
            for side in sides:
                side.start()
            try:
                summary["demo"] = _serve_demo(tmp, repo, pipe_dir)
            finally:
                for side in sides:
                    side.join()
            if "error" in calib_out:
                raise AssertionError(f"serve: calibrate_pipeline: {calib_out['error']!r}"
                                     ) from calib_out["error"]
            summary["calibrate"] = calib_out["result"]
            if "error" in probe_out:
                raise AssertionError(f"serve: probe raised {probe_out['error']}")
            sel = probe_out["result"]
            with open(records) as f:
                record = json.loads(f.read().splitlines()[-1])
            print(f"serve: probe in {time.perf_counter() - t0:.1f}s: {sel}", flush=True)
            first = sel["probe"][0]
            if (sel["mode"] != "latency" or first["mode"] != "latency" or not first["ok"]
                    or len(sel["probe"]) != 1 or record["mode"] != "latency"):
                raise AssertionError(f"serve: the probe did not pick latency first: {sel}")
            summary["probe"] = sel["probe"]

            summary["server"] = _serve_server(tmp, repo, calib_dir)

            # in process: the batched call under throughput
            t0 = time.perf_counter()
            droma = D3RoMa([f"task={SERVE_PRESET}", "task.image_size=[360,640]",
                            "task.num_intermediate_images=1", "task.fast_inference=throughput",
                            f"task.resume_pretrained={calib_dir}"],
                           Realsense.default_real("fxm"), variant="rgb+raw")
            lat = D3RoMa([f"task={SERVE_PRESET}", "task.image_size=[360,640]",
                          "task.num_intermediate_images=1", "task.fast_inference=latency",
                          f"task.resume_pretrained={pipe_dir}"],
                         Realsense.default_real("fxm"), variant="rgb+raw")
            fxb = droma.camera.fxb_depth
            print(f"serve: D3RoMa (throughput, calibrated) and D3RoMa (latency, the same "
                  f"weights) loaded in {time.perf_counter() - t0:.1f}s", flush=True)

            def batched():
                return droma.infer_with_rgb_raw_batch(frames)

            t0 = time.perf_counter()
            batched()
            _sync()
            print(f"serve: first batched call {time.perf_counter() - t0:.2f}s", flush=True)
            steps = cfg.num_inference_timesteps
            convs = _calibrated_conv_sites(droma.pipeline, SERVE_BATCH, SERVE_HW)
            expected = {"attention_int8": 10 * steps + 2, "geglu_int8": 16 * steps,
                        "conv2d_int8": convs["vae_encode"] + convs["unet"] * steps
                        + convs["vae_decode"]}
            expected["quantize"] = expected["conv2d_int8"] + expected["geglu_int8"]
            expected["conv2d_int8_xla"] = expected["conv2d_int8"]
            _zero_launches()
            batched()
            _sync()
            counts = _int8_launches()
            _check_counts("serve throughput batch 4", counts, expected)
            summary["launches_throughput"] = {k: v for k, v in counts.items() if v}

            droma._generator.manual_seed(21)
            fast = batched()
            droma._generator.manual_seed(21)
            same = _plain_int8_forward(batched, attention=False)
            exact = max(float(np.abs(a - b).max()) for a, b in zip(fast, same))
            print(f"serve: batched depth through the kernels against the conv, GEGLU and "
                  f"quantize kernels' plain versions: max |a - b| = {exact} (must be 0)",
                  flush=True)
            if exact != 0.0:
                raise AssertionError(f"serve: bit-equal kernels differ by {exact}")
            # the yardstick holds no kernel under test: every plain int8
            # version against every plain bf16 version, the same noise
            droma._generator.manual_seed(21)
            ref = _plain_int8_forward(batched)
            lat._generator.manual_seed(21)
            noise = _depth_rel(ref, _plain_bf16(lambda: lat.infer_with_rgb_raw_batch(frames)),
                               fxb)
            print(f"serve: int8 noise of the batched call: its depth through every plain "
                  f"version against the same call in bf16 (latency) through every plain "
                  f"version {noise:.3e}", flush=True)
            summary["batch_int8_noise"] = noise
            summary["batch_rel"] = _kernel_vs_plain("serve throughput batch 4", droma, batched,
                                                    _plain_int8_forward, 21, fxb,
                                                    tol=2 * noise, fast=fast, ref=ref)

            # pre, pipeline and post with no host synchronization
            stacked = [droma._prep_rgb_raw(*f) for f in frames]
            up = droma._upload(raw_disp=np.stack([s[1] for s in stacked]),
                               rgb=np.stack([s[0] for s in stacked]))
            torch.cuda.set_sync_debug_mode("error")
            try:
                depth, unc = droma._device(**up)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            droma._fetch(depth, unc)
            print("serve: the batched call's pre, pipeline and post under "
                  "set_sync_debug_mode('error'): no host synchronization", flush=True)

            # timings of the throughput D3RoMa
            ms_batch, walls_batch = _median_ms(batched, SERVE_BATCH)
            one = frames[0]
            ms_t1, walls_t1 = _median_ms(lambda: droma.infer_with_rgb_raw(*one), 1)
            wall_ms, busy_ms = profile_phase(batched, "serve throughput batch 4",
                                             frames=SERVE_BATCH)
            idle = max(0.0, 1 - busy_ms / wall_ms)
            big = _serve_frame(7, 1.0, (480, 848))
            host = {}
            for label, frame in (("360x640", one), ("480x848", big)):
                reps = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    r, d = droma._prep_rgb_raw(*frame)
                    droma._upload(raw_disp=d[None], rgb=r[None])
                    _sync()
                    reps.append((time.perf_counter() - t0) * 1e3)
                host[f"pre_ms_{label}"] = statistics.median(reps)
            reps = []
            for _ in range(5):
                depth, unc = droma._device(**up)
                _sync()
                t0 = time.perf_counter()
                droma._fetch(depth, unc)
                reps.append((time.perf_counter() - t0) * 1e3)
            host["post_copy_ms_batch4"] = statistics.median(reps)
            print(f"serve: throughput infer_with_rgb_raw_batch {ms_batch:.2f} ms/frame (batch "
                  f"{SERVE_BATCH}, median of {[round(w, 2) for w in walls_batch]}); "
                  f"infer_with_rgb_raw {ms_t1:.2f} ms/request (batch 1, median of "
                  f"{[round(w, 2) for w in walls_t1]}); profiled batched call idle share "
                  f"{idle:.3f}, device busy {busy_ms / SERVE_BATCH:.2f} ms/frame; host "
                  f"{ {k: round(v, 3) for k, v in host.items()} }", flush=True)
            summary.update(ms_per_frame_batch4_throughput=ms_batch,
                           ms_per_request_throughput=ms_t1, idle_share_batch4=idle,
                           device_busy_ms_per_frame_batch4=busy_ms / SERVE_BATCH, host_ms=host)
            del droma
            torch.cuda.empty_cache()

            # under latency: rgb+raw and left+right+raw at batch 1
            single = lambda: lat.infer_with_rgb_raw(*one)  # noqa: E731
            single()
            _sync()
            bf16 = {"attention": 10 * steps, "geglu": 16 * steps}
            summary["launches_latency"] = _serve_counts("serve latency rgb+raw batch 1",
                                                        single, bf16)
            summary["rel_latency_rgb_raw"] = _kernel_vs_plain(
                "serve latency rgb+raw batch 1", lat, single, _plain_bf16, 31, fxb)
            r, d = lat._prep_rgb_raw(*one)
            up1 = lat._upload(raw_disp=d[None], rgb=r[None])
            torch.cuda.set_sync_debug_mode("error")
            try:
                depth, unc, metrics = lat._device(**up1, metrics=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            lat._fetch(depth[0], unc[0], metrics)
            print("serve: the single-frame path's pre, pipeline and post (metrics included) "
                  "under set_sync_debug_mode('error'): no host synchronization", flush=True)
            ms_l1, walls_l1 = _median_ms(single, 1)
            print(f"serve: latency infer_with_rgb_raw {ms_l1:.2f} ms/request (batch 1, median "
                  f"of {[round(w, 2) for w in walls_l1]})", flush=True)
            summary["ms_per_request_latency"] = ms_l1
            del lat
            torch.cuda.empty_cache()

            lr_pipe = latent_pipe("left+right+raw").fast_inference("latency")
            stereo = D3RoMa(["task=eval_ldm_mixed", "task.image_size=[360,640]",
                             "task.num_intermediate_images=1"],
                            Realsense.default_real("fxm"), variant="left+right+raw",
                            pipeline=lr_pipe)
            rs = np.random.RandomState(5)
            left = rs.randint(0, 256, SERVE_HW).astype(np.uint8)
            right = np.roll(left, -8, axis=1)
            pair = lambda: stereo.infer(left, right, raw_depth=one[1], rgb=one[0])  # noqa: E731
            pair()
            _sync()
            _serve_counts("serve latency left+right+raw batch 1", pair, bf16)
            summary["rel_latency_left_right_raw"] = _kernel_vs_plain(
                "serve latency left+right+raw batch 1", stereo, pair, _plain_bf16, 41, fxb)
            del stereo, lr_pipe
            torch.cuda.empty_cache()
        finally:
            os.chdir(cwd)
    return summary



def calibrate_cli(tmp, repo, pipe_dir, frames, steps, image_size="360x640"):
    """`python -m d3roma_tpu_torch.calibrate_pipeline pipe_dir` in its own
    process (`frames` procedural frames in one batch, `steps` DDIM steps):
    its act_scales.json holds the four tables, each non-empty, every scale
    finite and positive. Returns its seconds and table lengths."""
    import numpy as np

    rc, out, secs = _run_module(tmp, repo, "d3roma_tpu_torch.calibrate_pipeline", pipe_dir,
                                "--frames", str(frames), "--batches", "1", "--image-size",
                                image_size, "--steps", str(steps))
    if rc != 0:
        raise AssertionError(f"calibrate_pipeline exited {rc}")
    with open(os.path.join(pipe_dir, "act_scales.json")) as f:
        scales = json.load(f)
    sizes = {k: len(v) for k, v in scales.items()}
    if set(scales) != {"unet", "unet_cached", "vae_encode", "vae_decode"} or min(sizes.values()) < 1:
        raise AssertionError(f"calibrate_pipeline wrote the tables {sizes}")
    flat = np.concatenate([np.asarray(v, np.float64) for v in scales.values()])
    if not (np.isfinite(flat).all() and (flat > 0).all()):
        raise AssertionError("calibrate_pipeline wrote a scale that is not finite and positive")
    print(f"calibrate_pipeline: {frames} frames at {image_size}, {steps} steps, in its own "
          f"process in {secs:.1f}s; table lengths {sizes}", flush=True)
    return {"seconds": secs, "table_lengths": sizes}


def _calibrated_conv_sites(pipe, batch, hw):
    """The int8 conv launches a calibrated throughput call makes per table:
    the UNet's conv and dense sites from its call map (whose length must be
    the "unet" table's), the VAE tables' lengths (every static VAE site is a
    conv or dense one: its attention takes no scale)."""
    unet = pipe.quant_call_map(batch, *hw)["unet"]
    if len(unet) != len(pipe.act_scales["unet"]):
        raise AssertionError(f"the unet table holds {len(pipe.act_scales['unet'])} scales for "
                             f"{len(unet)} sites")
    return {"unet": sum(1 for kind, _ in unet if kind in ("conv", "dot")),
            "vae_encode": len(pipe.act_scales["vae_encode"]),
            "vae_decode": len(pipe.act_scales["vae_decode"])}


OFFLINE_BATCH = 4  # the stereo CLI's default batch
OFFLINE_CLI_FRAMES = 8
# the matcher on the card against the same call on the CPU, as
# tests/test_torch_stereo.py holds the port against JAX: the same validity
# on OFFLINE_VALID_AGREE of the pixels, the disparity within
# OFFLINE_DISP_ATOL px where both are valid (the output is discontinuous at
# the LRC threshold and the range cut, and the softmax at beta 100 amplifies
# last-place cost differences)
OFFLINE_VALID_AGREE = 0.995
OFFLINE_DISP_ATOL = 0.15
# the box sums against float64: fp32 rounding only (TF32 or an average
# re-multiplied misses by ~1e-3)
OFFLINE_BOX_REL_TOL = 1e-6
OFFLINE_VALID_MIN = 0.3  # the CLI's sim depth: valid on at least this share of a frame
REPROJECT_HW = (720, 1280)
REPROJECT_AGREE = 0.999  # pixels with the same hole and depth within 1e-5 (rounding ties)
# the guided eval batch: DDIM steps and Adam steps a step (fewer than the
# preset's 10 steps: the phase's time limit)
OFFLINE_EVAL_STEPS = 3
OFFLINE_OPT_STEPS = 2


def _ir_pairs(n, seed):
    """n procedural IR pairs at 360x640, [n, H, W, 1] in [0, 1], and fxb."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.synthetic import ProceduralSceneRenderer, SceneConfig

    renderer = ProceduralSceneRenderer(SceneConfig(), seed)
    frames = [renderer.render() for _ in range(n)]
    left, right = (torch.from_numpy(np.stack([f[k] for f in frames]).astype(np.float32)
                                    / 255.0)[..., None] for k in ("ir_l", "ir_r"))
    return left, right, frames[0]["fxb"]


def _stereo_agree(label, ours, ref):
    """ours (any device) against ref (the CPU) at the tests' tolerance;
    returns (validity agreement, max disparity error where both valid)."""
    import numpy as np

    ov, rv = ours.valid.cpu().numpy(), ref.valid.cpu().numpy()
    agree = float((ov == rv).mean())
    both = ov & rv
    err = float(np.abs(ours.disp.cpu().numpy()[both] - ref.disp.cpu().numpy()[both]).max())
    print(f"{label}: validity agrees on {agree:.5f} of the pixels (limit {OFFLINE_VALID_AGREE}), "
          f"max |disp a - b| where both valid {err:.4f} px (tol {OFFLINE_DISP_ATOL}); valid "
          f"share {rv.mean():.4f}", flush=True)
    if not (agree >= OFFLINE_VALID_AGREE and err <= OFFLINE_DISP_ATOL):
        raise AssertionError(f"{label}: the card's matcher against the CPU's: {agree}, {err}")
    return agree, err


def _stereo_on_card(tmp, card):
    """stereo_match at 360x640, batch OFFLINE_BATCH, the CLI's defaults
    (D 101), against the CPU; TF32 settings that change nothing; the box sums
    against float64; ms/frame, peak memory, the StepTimer summary and one
    profiling.trace file read back."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.ops import stereo
    from d3roma_tpu_torch.utils.profiling import StepTimer, trace

    timer = StepTimer()
    left, right, fxb = _ir_pairs(OFFLINE_BATCH, 19)
    held = {}
    with timer.phase("upload", block_on=held):
        held["l"], held["r"] = left.cuda(), right.cuda()
    lc, rc = held["l"], held["r"]
    t0 = time.perf_counter()
    out = stereo.stereo_match(lc, rc, fxb)
    _sync()
    first_s = time.perf_counter() - t0
    # neither TF32 switch reaches the matcher: the same bits with both on and off
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = stereo.stereo_match(lc, rc, fxb)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        off = stereo.stereo_match(lc, rc, fxb)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    if not (torch.equal(on.disp, off.disp) and torch.equal(on.disp, out.disp)):
        raise AssertionError("offline: the matcher's result moves with the TF32 settings")
    box = stereo._box_sum(lc, 11).double().cpu()
    box64 = stereo._box_sum(left.double(), 11)
    box_rel = float((box - box64).abs().max() / box64.abs().max())
    print(f"offline: stereo box sums on the card against float64 max |a - b| / max |b| "
          f"{box_rel:.3e} (tol {OFFLINE_BOX_REL_TOL}); the disparities bit-equal with TF32 on "
          f"and off", flush=True)
    if not box_rel <= OFFLINE_BOX_REL_TOL:
        raise AssertionError(f"offline: box sums {box_rel} from float64")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the inputs and what earlier phases still hold
    walls = []
    for _ in range(3):
        res = {}
        t0 = time.perf_counter()
        with timer.phase("match", block_on=res):
            res["out"] = stereo.stereo_match(lc, rc, fxb)
        walls.append((time.perf_counter() - t0) * 1e3 / OFFLINE_BATCH)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30  # the matcher's own
    with timer.phase("download"):
        host = [t.cpu() for t in res["out"]]
    t0 = time.perf_counter()
    ref = stereo.stereo_match(left, right, fxb)
    cpu_s = time.perf_counter() - t0
    agree, err = _stereo_agree("offline: stereo_match card vs CPU", res["out"], ref)
    if not np.isfinite(host[2].numpy()).all():
        raise AssertionError("offline: non-finite sim depth")
    trace_dir = os.path.join(tmp, "trace")
    with trace(trace_dir):
        stereo.stereo_match(lc, rc, fxb)
        _sync()
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if len(files) != 1 or not events or not kernels:
        raise AssertionError(f"offline: the trace {files} holds {len(events)} events, "
                             f"{kernels} kernels")
    ms = min(walls)
    summary = {k: v * 1e3 for k, v in timer.summary().items()}
    print(f"offline: stereo_match {OFFLINE_BATCH}x360x640, D 101, block 11: {ms:.2f} ms/frame "
          f"(the faster of {[round(w, 2) for w in walls]}; first call {first_s:.2f}s), peak "
          f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before, the CPU "
          f"{cpu_s:.1f}s; StepTimer ms/it { {k: round(v, 2) for k, v in summary.items()} }; "
          f"trace {files[0]}: {len(events)} events, {kernels} kernels; {card}", flush=True)
    return {"ms_per_frame": ms, "walls_ms_per_frame": walls, "first_call_s": first_s,
            "peak_gib": peak, "held_before_gib": base / 2**30, "cpu_s": cpu_s,
            "valid_agree": agree, "max_disp_err": err, "box_rel_err": box_rel,
            "step_timer_ms": summary, "trace_events": len(events), "trace_kernels": kernels}


def _stereo_cli(tmp, repo, card):
    """`python -m d3roma_tpu_torch.stereo_matching` on an 8-frame tree in its
    own process; its EXRs read back through native_io and utils/exr.py."""
    import numpy as np

    from d3roma_tpu_torch.synthetic import generate_dataset
    from d3roma_tpu_torch.utils import exr, native_io

    scene = generate_dataset(os.path.join(tmp, "cli", "HISS"), OFFLINE_CLI_FRAMES, split="train",
                             seed=23)
    rc, out, secs = _run_module(tmp, repo, "d3roma_tpu_torch.stereo_matching",
                                os.path.join(tmp, "cli"), "--overwrite")
    if rc != 0:
        raise AssertionError(f"stereo_matching exited {rc}")
    per_frame = [float(ln.split()[0]) for ln in out.splitlines() if ln.endswith(" s/frame")]
    paths = sorted(os.path.join(scene, n) for n in os.listdir(scene)
                   if n.endswith("_simDepthImage.exr"))
    pngs = [p.replace("_simDepthImage.exr", "_simDispImage.png") for p in paths]
    if len(paths) != OFFLINE_CLI_FRAMES or not per_frame or not all(map(os.path.exists, pngs)):
        raise AssertionError(f"stereo_matching wrote {len(paths)} depth maps: {out[-2000:]}")
    native_io.read_exr(paths[0])  # loads the library; the files are in the page cache after

    def timed(read):
        t0 = time.perf_counter()
        out = read()
        return out, (time.perf_counter() - t0) * 1e3 / len(paths)

    # in turns (Python, native, batch, batch, native, Python), the faster of each pair
    py, py_ms = timed(lambda: [exr.read_exr(p) for p in paths])
    nat, nat_ms = timed(lambda: [native_io.read_exr(p) for p in paths])
    (batch, status), batch_ms = timed(lambda: native_io.read_exr_batch(paths))
    batch_ms = min(batch_ms, timed(lambda: native_io.read_exr_batch(paths))[1])
    nat_ms = min(nat_ms, timed(lambda: [native_io.read_exr(p) for p in paths])[1])
    py_ms = min(py_ms, timed(lambda: [exr.read_exr(p) for p in paths])[1])
    valid = [float((d > 0).mean()) for d in py]
    for a, b, c in zip(py, nat, batch):
        if a.shape != (360, 640) or not (np.array_equal(a, b) and np.array_equal(a, c)):
            raise AssertionError("offline: the native and Python EXR reads differ")
        if not np.isfinite(a).all():
            raise AssertionError("offline: non-finite sim depth in an EXR")
    if not (status > 0).all() or min(valid) < OFFLINE_VALID_MIN:
        raise AssertionError(f"offline: EXR status {status}, valid shares {valid}")
    print(f"offline: stereo_matching on {len(paths)} frames in its own process in {secs:.1f}s "
          f"({per_frame[0]:.4f} s/frame as it prints); EXRs bit-equal through native_io and "
          f"utils/exr.py, valid {min(valid):.3f}-{max(valid):.3f} (limit {OFFLINE_VALID_MIN}); "
          f"decode ms an item (360x640 fp32, warm page cache): native {nat_ms:.3f}, native "
          f"batch {batch_ms:.3f}, Python {py_ms:.3f}; {card}", flush=True)
    return {"process_s": secs, "s_per_frame": per_frame[0], "valid_share": valid,
            "native_ms_per_item": nat_ms, "native_batch_ms_per_item": batch_ms,
            "python_ms_per_item": py_ms}


def _reproject_on_card(card):
    """reproject_depth at 1280x720 (the fxm camera, depth to color) on the
    card against the CPU, with TF32 matmul off as PyTorch leaves it."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.ops.reproject import reproject_depth
    from d3roma_tpu_torch.utils.camera import Realsense

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("offline: TF32 matmul is on before the reprojection")
    cam = Realsense.default_real("fxm")
    cam.change_resolution(f"{REPROJECT_HW[1]}x{REPROJECT_HW[0]}")
    rs = np.random.RandomState(31)
    depth = rs.uniform(0.3, 3.0, REPROJECT_HW).astype(np.float32)
    depth[rs.random_sample(REPROJECT_HW) < 0.2] = 0.0
    mats = [torch.from_numpy(np.asarray(m, np.float32))
            for m in (cam.K_depth.arr, cam.K_color.arr, cam.T_cl)]
    ref = reproject_depth(torch.from_numpy(depth), *mats, REPROJECT_HW).numpy()
    dev = torch.from_numpy(depth).cuda()
    reproject_depth(dev, *mats, REPROJECT_HW)
    _sync()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = reproject_depth(dev, *mats, REPROJECT_HW)
        _sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    got = got.cpu().numpy()
    same = ((got > 0) == (ref > 0)) & (np.abs(got - ref) <= 1e-5 * np.abs(ref))
    agree = float(same.mean())
    print(f"offline: reproject_depth {REPROJECT_HW[1]}x{REPROJECT_HW[0]} card against CPU: "
          f"{agree:.6f} of the pixels agree (limit {REPROJECT_AGREE}), filled "
          f"{(ref > 0).mean():.4f}; {min(walls):.3f} ms; {card}", flush=True)
    if not agree >= REPROJECT_AGREE:
        raise AssertionError(f"offline: reprojection card against CPU {agree}")
    return {"agree": agree, "ms": min(walls)}


class _TargetSpy:
    """A pipeline that records the guidance target and the IR pair of each
    call (eval_batch's stereo-match branch)."""

    def __init__(self, pipe):
        self.pipe, self.seen = pipe, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, **kw):
        self.seen.append({k: kw[k].detach() for k in ("raw_depth", "left_images",
                                                      "right_images")})
        return self.pipe(**kw)


def _eval_stereo_match(tmp, card):
    """One evaluate_dataset batch under guide_source="stereo-match": the
    left+right+raw latent pipeline at full width (seeded random weights,
    bf16, latency), gradient guidance at weight 1.0, two procedural frames
    at 480x270; the target the pipeline received against the CPU matcher
    on the same IR pair, finite metrics, the latency kernels launched."""
    from functools import partial

    import numpy as np
    import torch

    from d3roma_tpu_torch.config import load_task_preset
    from d3roma_tpu_torch.data import preprocess_eval, val_loaders
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.guidance import FlowGuidance
    from d3roma_tpu_torch.models import (
        AutoencoderKL,
        UNet2DCondition,
        init_random_,
        widened_in_channels,
    )
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.ops.stereo import StereoMatchOutput, stereo_match
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
    from d3roma_tpu_torch.synthetic import generate_dataset

    cfg = load_task_preset("eval_ldm_mixed")
    cfg.eval_dataset, cfg.eval_batch_size, cfg.eval_num_batch = ["HISS"], 2, 1
    cfg.guide_source, cfg.flow_guidance_weights = "stereo-match", [1.0]
    cfg.num_inference_timesteps = OFFLINE_EVAL_STEPS
    generate_dataset(os.path.join(tmp, "datasets", "HISS"), 2, split="test", seed=29)
    gen = torch.Generator(device="cuda").manual_seed(7)
    norm = Normalizer.from_config(cfg)
    pipe = GuidedLatentDiffusionPipeline(
        unet=init_random_(UNet2DCondition(in_channels=widened_in_channels(cfg.cond_channels),
                                          out_channels=4, device="cuda"), gen),
        vae=init_random_(AutoencoderKL(device="cuda"), gen), text_embed=torch.zeros(1, 2, 1024),
        spec=create_sampler_spec(cfg, train=False), normalizer=norm,
        guidance=FlowGuidance(flow_guidance_weight=1.0, flow_guidance_mode="gradient",
                              num_opt_steps=OFFLINE_OPT_STEPS, opt_lr=1e-3),
        device="cuda").half_precision().fast_inference("latency")
    spy = _TargetSpy(pipe)
    cwd = os.getcwd()
    os.chdir(tmp)  # the dataset root is relative to the working directory
    try:
        _zero_launches()
        t0 = time.perf_counter()
        metrics, _ = evaluate_dataset(
            cfg, spy, val_loaders(cfg)[0], torch.Generator().manual_seed(1),
            preprocess=partial(preprocess_eval, config=cfg, normalizer=norm, device="cuda"))
        _sync()
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = {k: v for k, v in _int8_launches().items() if v}
    flat = [v for grp in ("disp", "depth") for v in metrics[grp].values()]
    if len(spy.seen) != 1 or not np.isfinite(flat).all():
        raise AssertionError(f"offline eval: {len(spy.seen)} calls, metrics {metrics}")
    if not (counts.get("attention") and counts.get("geglu")):
        raise AssertionError(f"offline eval: the latency kernels did not launch: {counts}")
    seen = spy.seen[0]
    left, right = ((seen[k].float().cpu() + 1.0) / 2.0 for k in ("left_images", "right_images"))
    scale = left.shape[2] / 640.0
    # fxb scales the depth only: the disparities are compared
    ref = stereo_match(left, right, 24.0, min_disp=max(1, int(10 * scale)),
                       max_disp=max(8, int(110 * scale)))
    target = seen["raw_depth"][..., 0].float().cpu()
    got = StereoMatchOutput(torch.where(target > 0, target, torch.full_like(target, -1.0)),
                            target > 0, None)
    agree, err = _stereo_agree("offline eval: the stereo-match target vs the CPU matcher",
                               got, ref)
    print(f"offline eval: one batch of 2 frames ({tuple(left.shape[1:3])} padded), "
          f"{OFFLINE_EVAL_STEPS} steps, gradient guidance ({OFFLINE_OPT_STEPS} Adam steps a "
          f"step) on the stereo-match target in {secs:.1f}s; launches {counts}; disp/epe "
          f"{metrics['disp']['epe']:.4f}, depth/rel {metrics['depth']['rel']:.4f}; {card}",
          flush=True)
    del pipe, spy
    torch.cuda.empty_cache()
    return {"seconds": secs, "launches": counts, "target_valid_agree": agree,
            "target_max_disp_err": err, "metrics": metrics}


def offline_phase(card, calibration=None):
    """The offline tooling on the card (`offline_phase`), each step failing
    the run on its own error:

    - `ops/stereo.py::stereo_match` at 360x640, batch 4, the stereo CLI's
      defaults (D 101, block 11, beta 100) on procedural IR pairs against
      the same call on the CPU (OFFLINE_VALID_AGREE, OFFLINE_DISP_ATOL); the
      disparities bit-equal with cuDNN's and matmul's TF32 switches on and
      off, and the box sums within OFFLINE_BOX_REL_TOL of float64 (no TF32
      reaches them); ms/frame (the faster of three calls), peak memory, the
      phase's StepTimer summary and one `utils.profiling.trace` file read
      back with its kernels;
    - `python -m d3roma_tpu_torch.stereo_matching` on an 8-frame procedural
      tree in its own process; each EXR read back through `native_io` (one
      by one and batched) and `utils/exr.py`, bit-equal, finite, valid on
      OFFLINE_VALID_MIN of the frame at least; decode ms an item;
    - `reproject_depth` at 1280x720 on the card against the CPU;
    - one `evaluate_dataset` batch under guide_source="stereo-match"
      (`_eval_stereo_match`);
    - `calibrate_pipeline` as a process: the serve phase's (`calibration`,
      which replaces the serve phase's own calibration step), or, run
      alone, one on the serve phase's rgb+raw pipeline (`serve_latent_pipe`),
      saved, at 2 frames and 2 steps.

    Returns a summary dict."""
    import tempfile

    import torch

    repo = os.path.dirname(os.path.abspath(__file__))
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        summary["stereo"] = _stereo_on_card(tmp, card)
        torch.cuda.empty_cache()
        summary["stereo_cli"] = _stereo_cli(tmp, repo, card)
        summary["reproject"] = _reproject_on_card(card)
        summary["eval_stereo_match"] = _eval_stereo_match(tmp, card)
        if calibration is None:
            from d3roma_tpu_torch.config import compose

            pipe_dir = os.path.join(tmp, "pipe")
            serve_latent_pipe(compose([f"task={SERVE_PRESET}"]).task, "rgb+raw",
                              torch.Generator(device="cuda").manual_seed(3)
                              ).save_pretrained(pipe_dir)
            torch.cuda.empty_cache()
            calibration = calibrate_cli(tmp, repo, pipe_dir, 2, 2)
        summary["calibrate"] = calibration
    return summary


MONO_FIXTURES = os.path.join("tests", "data", "torch_mono")
MONO_TRAIN_PRESET = "train_ldm_mono"
MONO_EVAL_PRESET = "eval_ldm_mono"
MONO_ITEMS = 8  # items a train set: symlinks to its two committed fixture frames
MONO_WEIGHT = 2  # dataset_weight of each set: 32 items, 2 steps of batch 16 in one epoch
MONO_EVAL_FRAMES = 4  # NYUv2 test frames: one batch of the presets' eval_batch_size
MONO_EVAL_STEPS = 3  # the evaluate entry point's my_ddim steps (the preset's 10, cut)
MONO_DECODE_REPS = 5


def _sha256(arr) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _decode_ms(fn, reps=MONO_DECODE_REPS) -> float:
    """Median wall ms of fn() over reps calls after one warm call (warm
    page cache)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def mono_fixtures(repo: str) -> dict:
    """Every committed mono fixture decoded by the port's host readers (the
    JPEG decoder built by g++, the HDF5 reader on numpy and zlib; this
    machine has neither PIL nor h5py), each array's shape, dtype and sha256
    equal to the manifest PIL and h5py wrote; the decode ms of an item."""
    from d3roma_tpu_torch.utils import hdf5
    from d3roma_tpu_torch.utils.jpeg import read_jpeg

    root = os.path.join(repo, MONO_FIXTURES)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    checked = 0
    for rel, arrays in sorted(manifest.items()):
        path = os.path.join(root, rel)
        if rel.endswith(".jpg"):
            got = {"": read_jpeg(path)}
        else:
            h5 = hdf5.File(path)
            got = {k: h5[k] for k in arrays}
        for name, want in arrays.items():
            arr = got[name]
            ours = dict(shape=list(arr.shape), dtype=arr.dtype.str, sha256=_sha256(arr))
            if ours != want:
                raise AssertionError(f"mono: {rel}[{name!r}] decoded {ours}, manifest {want}")
            checked += 1
    nyu = os.path.join(root, "nyu_depth_v2/official_splits/train/bedroom_0001/00000.h5")
    hypersim = os.path.join(root, "hypersim/ai_001_001/frame.0000")

    def nyu_item():
        f = hdf5.File(nyu)
        return f["rgb"], f["depth"]

    ms = {"jpeg_768x1024_420": _decode_ms(lambda: read_jpeg(hypersim + ".tonemap.jpg")),
          "jpeg_480x640_420": _decode_ms(
              lambda: read_jpeg(os.path.join(root, "jpeg/baseline_420_480x640.jpg"))),
          "nyu_h5_rgb_and_depth": _decode_ms(nyu_item),
          "hypersim_hdf5_768x1024_f16": _decode_ms(
              lambda: hdf5.read_dataset(hypersim + ".depth_meters.hdf5", "dataset"))}
    print(f"mono: {len(manifest)} fixtures, {checked} arrays decoded by the port, each "
          f"sha256 the manifest's (PIL's and h5py's); decode ms an item (median of "
          f"{MONO_DECODE_REPS}, warm page cache): "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}", flush=True)
    return dict(files=len(manifest), arrays=checked, decode_ms=ms)


def _mono_trees(tmp: str, repo: str) -> None:
    """datasets/ under tmp from symlinks to the fixtures: MONO_ITEMS NYUv2
    train items and MONO_ITEMS HyperSim train frames (alternating between
    each set's two fixture frames), MONO_EVAL_FRAMES NYUv2 test items."""
    root = os.path.join(repo, MONO_FIXTURES)
    nyu = ("nyu_depth_v2/official_splits/train/bedroom_0001/00000.h5",
           "nyu_depth_v2/official_splits/test/kitchen_0002/00001.h5")
    hypersim = ("hypersim/ai_001_001/frame.0000", "hypersim/ai_001_002/frame.0001")

    def link(src, dst):
        dst = os.path.join(tmp, "datasets", dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.symlink(os.path.join(root, src), dst)

    for i in range(MONO_ITEMS):
        link(nyu[i % 2], f"nyu_depth_v2/official_splits/train/scene_{i // 2:02d}/{i:05d}.h5")
        for ext in (".tonemap.jpg", ".depth_meters.hdf5"):
            link(hypersim[i % 2] + ext,
                 f"hypersim/train/ai_{i // 2:03d}/images/frame.{i:04d}{ext}")
    for i in range(MONO_EVAL_FRAMES):
        link(nyu[i % 2], f"nyu_depth_v2/official_splits/test/scene_{i:02d}/{i:05d}.h5")


def _device_busy_ms(prof) -> float:
    """Device ms of a finished torch.profiler session's kernels, copies and
    memsets (not the record_function ranges the profiler also draws on the
    device's timeline), summed from its raw kineto events: the FunctionEvent
    parse of a training step's tens of thousands of ops takes seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA

    def counted(name):
        return not name.startswith("train_step/") and "Sync" not in name

    try:
        events = prof.profiler.kineto_results.events()
        return sum(e.duration_ns() for e in events
                   if e.device_type() == cuda and counted(e.name())) / 1e6
    except AttributeError:  # a torch without the raw events
        return sum(e.device_time_total for e in prof.events()
                   if getattr(e, "device_type", None) == cuda and counted(e.name)) / 1e3


def train_child(out_path: str, argv, item_class) -> int:
    """`python -m d3roma_tpu_torch.train argv` (runpy, in this process) with
    timing hooks: each train step synchronized and timed, the second under
    torch.profiler (its wall up to the synchronize, its device busy ms and
    idle share), the host ms of every item of `item_class` the loader's
    threads build (the in-training eval's items too), the peak memory, and
    the hand kernels' launch counts of the run (set to 0 before it); the
    record written to out_path as JSON."""
    import runpy
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from d3roma_tpu_torch.training import train_loop

    record = dict(step_ms=[], item_ms=[])
    lock = threading.Lock()
    get_item = item_class.__getitem__

    def timed_item(self, index):
        t0 = time.perf_counter()
        out = get_item(self, index)
        with lock:
            record["item_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    make_step = train_loop.make_train_step

    def make_timed(*args, **kw):
        step = make_step(*args, **kw)

        def timed(state, batch, draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(record["step_ms"]) != 1:
                out = step(state, batch, draws)
                torch.cuda.synchronize()
                record["step_ms"].append((time.perf_counter() - t0) * 1e3)
                return out
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = step(state, batch, draws)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            record["step_ms"].append(wall)
            busy = _device_busy_ms(prof)
            record["device_busy_ms"] = busy
            record["idle_share"] = max(0.0, 1 - busy / wall)
            return out

        return timed

    item_class.__getitem__ = timed_item
    train_loop.make_train_step = make_timed
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    sys.argv = ["d3roma_tpu_torch.train"] + list(argv)
    rc = 0
    try:
        runpy.run_module("d3roma_tpu_torch.train", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code or 0
    record["launches"] = _int8_launches()
    record["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(out_path, "w") as f:
        json.dump(record, f)
    return int(rc)


def mono_train_child(out_path: str, argv) -> int:
    """The mono phase's train entry point: `train_child` timing the mono
    datasets' items."""
    from d3roma_tpu_torch.data import mono_datasets

    return train_child(out_path, argv, mono_datasets.MonoDataset)


def _mono_train_start(tmp: str, repo: str):
    """Start the train entry point on the mono preset at full width in its
    own process (`mono_train_child`): 2 steps, the in-training eval at step
    2 on one batch of the NYUv2 test frames, best/ exported. Returns the
    process once train.log says best/ was exported (the evaluate entry
    point may read it while the checkpoint is still being written) or the
    process has ended."""
    out = open(os.path.join(tmp, "train.out"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "chip_smoke.py"), "--mono-train",
         os.path.join(tmp, "train_record.json"), f"task={MONO_TRAIN_PRESET}",
         f"task.dataset_weight=[{MONO_WEIGHT},{MONO_WEIGHT}]", "task.num_epochs=1",
         "task.val_every_global_steps=2", "task.eval_num_batch=1",
         f"task.num_inference_timesteps={MONO_EVAL_STEPS}", "task.save_model_epochs=2",
         "task.output_dir=run"],
        cwd=tmp, stdout=out, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    out.close()
    _wait_for_best(tmp, proc, "mono")
    return proc


def _mono_train_finish(tmp: str, proc, t0: float) -> dict:
    """Wait for the train process; its steps, eval and export checked, its
    timing record read."""
    import math

    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(os.path.join(tmp, "train.out")) as f:
            raise AssertionError(f"mono: train entry point failed ({rc}): {f.read()[-4000:]}")
    with open(os.path.join(tmp, "run", "train.log")) as f:
        log = f.read()
    with open(os.path.join(tmp, "train_record.json")) as f:
        record = json.load(f)
    steps = _logged_steps(log)
    if ([s for s, _, _ in steps] != [1, 2]
            or not all(math.isfinite(x) for _, l, g in steps for x in (l, g))):
        raise AssertionError(f"mono: train steps {steps}\n{log[-3000:]}")
    if "eval[0] @2:" not in log or not os.path.exists(
            os.path.join(tmp, "run", "best", "model_index.json")):
        raise AssertionError(f"mono: no eval at step 2 or no best/ export\n{log[-3000:]}")
    items = record["item_ms"]
    summary = dict(steps=steps, wall_s=wall, step_ms=record["step_ms"],
                   ms_per_step=record["step_ms"][1], device_busy_ms=record["device_busy_ms"],
                   idle_share=record["idle_share"], peak_memory_gib=record["peak_memory_gib"],
                   loader_items=len(items), loader_host_ms_per_item=statistics.mean(items))
    print(f"mono: train entry point ({MONO_TRAIN_PRESET}, full SD2.1 width, fp32, batch 16 at "
          f"180x320, {MONO_ITEMS} NYUv2 + {MONO_ITEMS} HyperSim items x{MONO_WEIGHT}) in "
          f"{wall:.1f}s; steps {steps}; step ms {[round(w, 1) for w in record['step_ms']]} (the "
          f"first with the process's warm-up; the second profiled: device busy "
          f"{record['device_busy_ms']:.1f} ms, idle share {record['idle_share']:.3f}); peak "
          f"memory {record['peak_memory_gib']:.2f} GiB; the loader's host "
          f"{summary['loader_host_ms_per_item']:.2f} ms an item over {len(items)} items; eval "
          f"at step 2 ({MONO_EVAL_STEPS} steps) and best/ written", flush=True)
    return summary


def _mono_eval(tmp: str, repo: str) -> dict:
    """The evaluate entry point on the mono preset, on the train run's best/
    export: MONO_EVAL_FRAMES NYUv2 test frames, my_ddim at MONO_EVAL_STEPS
    steps; finite metrics and the prediction files written."""
    import math

    out_dir = os.path.join(tmp, "eval_out")
    rc, stdout, seconds = _run_module(
        tmp, repo, "d3roma_tpu_torch.evaluate", f"task={MONO_EVAL_PRESET}",
        "task.resume_pretrained=run/best", f"task.num_inference_timesteps={MONO_EVAL_STEPS}",
        f"task.eval_output={out_dir}")
    if rc != 0:
        raise AssertionError(f"mono: evaluate entry point failed ({rc})")
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith('{"dataset"')]
    if len(lines) != 1 or lines[0]["dataset"] != "NYUv2":
        raise AssertionError(f"mono: evaluate printed {lines}")
    metrics = lines[0]["metrics"]
    values = [v for group in metrics.values() for v in group.values()]
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"mono: evaluate metrics not finite: {metrics}")
    preds = sorted(f for f in os.listdir(os.path.join(out_dir, "NYUv2"))
                   if f.endswith("_pred_disp.png"))
    if not preds:
        raise AssertionError("mono: evaluate wrote no prediction")
    print(f"mono: evaluate entry point ({MONO_EVAL_PRESET}, {MONO_EVAL_FRAMES} NYUv2 test "
          f"frames, my_ddim {MONO_EVAL_STEPS} steps) exit 0 in {seconds:.1f}s; metrics "
          f"{json.dumps(metrics)}; {len(preds)} prediction files", flush=True)
    return dict(wall_s=seconds, metrics=metrics, predictions=len(preds))


def mono_phase(after_fixtures=None) -> dict:
    """The monocular datasets on the card's machine: the committed fixtures
    through the port's decoders (`mono_fixtures`), then the mono presets
    through the train and evaluate entry points in their own processes on
    trees of symlinks to them; the evaluate process starts once the train
    process has exported best/, beside its checkpoint write. after_fixtures()
    is called once the decode timings are taken."""
    import tempfile
    import threading

    repo = os.path.dirname(os.path.abspath(__file__))
    summary = dict(fixtures=mono_fixtures(repo))
    if after_fixtures is not None:
        after_fixtures()
    with tempfile.TemporaryDirectory() as tmp:
        _mono_trees(tmp, repo)
        t0 = time.perf_counter()
        proc = _mono_train_start(tmp, repo)
        side, errors = None, []
        try:
            if proc.poll() is None or proc.returncode == 0:
                def evaluate():
                    try:
                        summary["eval"] = _mono_eval(tmp, repo)
                    except BaseException as e:  # raised after the join
                        errors.append(e)

                side = threading.Thread(target=evaluate)
                side.start()
            summary["train"] = _mono_train_finish(tmp, proc, t0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if side is not None:
                side.join()
        if errors:
            raise errors[0]
    return summary


SYN_SEED = 21  # the render's pinned seed (train; val and test take the next two)
SYN_SURFACES = 2  # the SimBackend's support surfaces
SYN_TRAIN_FRAMES = 8  # frames a surface: 16 train frames
SYN_EVAL_FRAMES = 2  # frames a surface of the val and test splits: 4 each
SYN_WEIGHT = 6  # dataset_weight: 96 items, 3 steps of the preset's batch 32 in one epoch
SYN_TRAIN_PRESET = "train_hiss"
SYN_EVAL_PRESET = "eval_his_sim"
SYN_VALID_MIN = OFFLINE_VALID_MIN  # the sim depth of every rendered pair
SYN_NARROW_WIDTHS = (32, 64)  # the narrow pixel model of the card-vs-CPU step
SYN_NARROW_HW = (64, 96)
SYN_CAMERA_FRAMES = 8  # camera_test's frames a thread on the bundled capture
SYN_PARAMS = "113.7M"  # the preset's UNet2D, as the train entry point logs it


def _syn_render_start(tmp: str, repo: str, split: str, frames: int, seed: int):
    """`python -m d3roma_tpu_torch.render_synthetic` on conf/synthetic/hssd.yaml
    (its 640x360 D435 geometry, backend auto) into datasets/HISS/<split>/hssd/
    (the HISS loader lists one directory level under a split)."""
    return subprocess.Popen(
        [sys.executable, "-m", "d3roma_tpu_torch.render_synthetic", f"seed={seed}",
         f"num_frames_per_surface={frames}", f"max_surfaces={SYN_SURFACES}",
         f"writer_config.output_dir=datasets/HISS/{split}/hssd"],
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo))


def _syn_render(tmp: str, repo: str) -> dict:
    """The three splits rendered side by side, each in its own process; every
    frame's files written, the PNGs and EXRs at 360x640; s/frame."""
    import numpy as np

    from d3roma_tpu_torch.utils.exr import read_exr
    from d3roma_tpu_torch.utils.png import read_png

    t0 = time.perf_counter()
    splits = {"train": SYN_TRAIN_FRAMES, "val": SYN_EVAL_FRAMES, "test": SYN_EVAL_FRAMES}
    procs = {split: _syn_render_start(tmp, repo, split, frames, SYN_SEED + i)
             for i, (split, frames) in enumerate(splits.items())}
    out = {}
    for split, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"synthetic: render {split} failed ({proc.returncode}): "
                                 f"{stderr[-3000:]}")
        n = SYN_SURFACES * splits[split]
        lines = stdout.strip().splitlines()
        if not lines[0].startswith(f"wrote {n} frames (seed ") or "SimBackend" not in stderr:
            raise AssertionError(f"synthetic: render {split} printed {stdout!r} {stderr!r}")
        root = os.path.join(tmp, "datasets", "HISS", split, "hssd")
        for i in range(n):
            for suffix in ("color.png", "ir_l.png", "ir_r.png", "depth.exr"):
                path = os.path.join(root, f"{i:04d}_{suffix}")
                arr = read_png(path) if suffix.endswith(".png") else read_exr(path)
                if arr.shape[:2] != (H, W) or not np.isfinite(arr).all():
                    raise AssertionError(f"synthetic: {path} {arr.shape}")
        metas = sorted(f for f in os.listdir(root) if f.startswith("meta_"))
        if len(metas) != SYN_SURFACES:
            raise AssertionError(f"synthetic: render {split} wrote {metas}")
        out[split] = dict(frames=n, s_per_frame=float(lines[1].split()[0]))
    wall = time.perf_counter() - t0
    print(f"synthetic: render_synthetic (hssd.yaml, 640x360, backend auto -> SimBackend, seed "
          f"{SYN_SEED}) wrote {', '.join(f'{k} {v['frames']}' for k, v in out.items())} frames "
          f"in three processes side by side, {wall:.1f} s; s/frame "
          f"{json.dumps({k: v['s_per_frame'] for k, v in out.items()})}", flush=True)
    return dict(splits=out, wall_s=wall)


def _syn_stereo(tmp: str, repo: str) -> dict:
    """`python -m d3roma_tpu_torch.stereo_matching datasets/HISS` at its
    defaults (the reference HISS run's): every pair's _simDepthImage.exr,
    finite, valid on at least SYN_VALID_MIN of each frame."""
    import glob

    import numpy as np

    from d3roma_tpu_torch.utils.exr import read_exr

    rc, stdout, seconds = _run_module(tmp, repo, "d3roma_tpu_torch.stereo_matching",
                                      os.path.join("datasets", "HISS"))
    if rc != 0:
        raise AssertionError(f"synthetic: stereo_matching failed ({rc})")
    pairs = sorted(glob.glob(os.path.join(tmp, "datasets", "HISS", "*", "hssd", "*_ir_l.png")))
    shares = []
    for left in pairs:
        depth = read_exr(left.replace("_ir_l.png", "_simDepthImage.exr"))
        if depth.shape != (H, W) or not np.isfinite(depth).all():
            raise AssertionError(f"synthetic: sim depth of {left} {depth.shape}")
        shares.append(float((depth > 0).mean()))
    n = SYN_SURFACES * (SYN_TRAIN_FRAMES + 2 * SYN_EVAL_FRAMES)
    if len(pairs) != n or min(shares) < SYN_VALID_MIN:
        raise AssertionError(f"synthetic: {len(pairs)} pairs, valid shares {shares}")
    s_per_frame = float(stdout.strip().splitlines()[-1].split()[0])
    print(f"synthetic: stereo_matching on {n} pairs in {seconds:.1f} s, {s_per_frame} s/frame "
          f"(its own clock); valid share min {min(shares):.4f}, mean "
          f"{statistics.mean(shares):.4f} (at least {SYN_VALID_MIN})", flush=True)
    return dict(pairs=n, wall_s=seconds, s_per_frame=s_per_frame, valid_min=min(shares),
                valid_mean=statistics.mean(shares))


def _syn_prepare(tmp: str, repo: str) -> dict:
    """The rendered tree with its sim depth: `_syn_render`, then `_syn_stereo`."""
    return dict(render=_syn_render(tmp, repo), stereo=_syn_stereo(tmp, repo))


def synthetic_train_child(out_path: str, argv) -> int:
    """The synthetic phase's train entry point: `train_child` timing the
    HISS items (left+right+raw from the rendered tree)."""
    from d3roma_tpu_torch.data import datasets

    return train_child(out_path, argv, datasets.HISS)


def synthetic_eval_child(out_path: str, argv) -> int:
    """`python -m d3roma_tpu_torch.evaluate argv` (runpy, in this process):
    the wall of each evaluate_dataset call (synchronized) and its frames,
    and the hand kernels' launch counts (set to 0 before it)."""
    import runpy

    import torch

    from d3roma_tpu_torch import evaluation

    record = dict(calls=[])
    evaluate = evaluation.evaluate_dataset

    def timed(config, pipeline, loader, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(config, pipeline, loader, *args, **kw)
        torch.cuda.synchronize()
        record["calls"].append(dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                                    frames=len(loader.dataset)))
        return out

    evaluation.evaluate_dataset = timed
    _zero_launches()
    sys.argv = ["d3roma_tpu_torch.evaluate"] + list(argv)
    rc = 0
    try:
        runpy.run_module("d3roma_tpu_torch.evaluate", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code or 0
    record["launches"] = _int8_launches()
    with open(out_path, "w") as f:
        json.dump(record, f)
    return int(rc)


def _syn_child(tmp: str, repo: str, flag: str, name: str, argv):
    out = open(os.path.join(tmp, f"{name}.out"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "chip_smoke.py"), flag,
         os.path.join(tmp, f"{name}_record.json"), *argv],
        cwd=tmp, stdout=out, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
    out.close()
    return proc


def _syn_train_finish(tmp: str, proc, t0: float) -> dict:
    """The train process's steps finite, its eval at the last step, the
    checkpoint and best/ written, no hand kernel launched; its record."""
    import math

    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    with open(os.path.join(tmp, "train.out")) as f:
        output = f.read()
    if rc != 0:
        raise AssertionError(f"synthetic: train entry point failed ({rc}): {output[-4000:]}")
    with open(os.path.join(tmp, "run", "train.log")) as f:
        log = f.read()
    with open(os.path.join(tmp, "train_record.json")) as f:
        record = json.load(f)
    steps = _logged_steps(log)
    n = SYN_WEIGHT * SYN_SURFACES * SYN_TRAIN_FRAMES // 32
    if ([s for s, _, _ in steps] != list(range(1, n + 1))
            or not all(math.isfinite(x) for _, l, g in steps for x in (l, g))):
        raise AssertionError(f"synthetic: train steps {steps}\n{log[-3000:]}")
    run = os.path.join(tmp, "run")
    if (f"eval[0] @{n}:" not in log
            or not os.path.exists(os.path.join(run, "best", "model_index.json"))
            or not os.path.exists(os.path.join(run, "checkpoints", "last", "state.pt"))):
        raise AssertionError(f"synthetic: no eval at step {n}, best/ or checkpoint\n{log[-3000:]}")
    if f"total trainable params: {SYN_PARAMS}" not in log + output:
        raise AssertionError("synthetic: the pixel UNet is not the preset's width")
    if any(record["launches"].values()):
        raise AssertionError(f"synthetic: hand kernels launched in training: {record['launches']}")
    items = record["item_ms"]
    step_ms = record["step_ms"]
    summary = dict(steps=steps, wall_s=wall, step_ms=step_ms, first_step_s=step_ms[0] / 1e3,
                   ms_per_step=step_ms[2], samples_per_s=32 / (step_ms[2] / 1e3),
                   profiled_step_ms=step_ms[1], device_busy_ms=record["device_busy_ms"],
                   idle_share=record["idle_share"], peak_memory_gib=record["peak_memory_gib"],
                   loader_items=len(items), loader_host_ms_per_item=statistics.mean(items),
                   launches=record["launches"])
    print(f"synthetic: train entry point ({SYN_TRAIN_PRESET}: UNet2D (128, 128, 256, 256, 512, "
          f"512), 113.7M params, left+right+raw, sample prediction, pyramid noise, fp32, batch "
          f"32 at 256x320; {SYN_SURFACES * SYN_TRAIN_FRAMES} rendered frames x{SYN_WEIGHT}) in "
          f"{wall:.1f} s; steps {steps}; step ms {[round(w, 1) for w in step_ms]} (the first "
          f"with the process's warm-up, the second profiled: device busy "
          f"{record['device_busy_ms']:.1f} ms, idle share {record['idle_share']:.3f}); "
          f"{summary['ms_per_step']:.1f} ms/step, {summary['samples_per_s']:.2f} samples/s; "
          f"peak memory {record['peak_memory_gib']:.2f} GiB; the loader's host "
          f"{summary['loader_host_ms_per_item']:.2f} ms an item over {len(items)} items; eval at "
          f"step {n}, checkpoint and best/ written; hand-kernel launches 0", flush=True)
    return summary


def _syn_eval(tmp: str, repo: str) -> dict:
    """`python -m d3roma_tpu_torch.evaluate task=eval_his_sim
    task.plot_intermediate_metrics=true` on best/ (the test split, my_ddpm at
    the preset's 8 steps, dynamic thresholding): finite metrics, every
    artifact read back, the intermediate-metrics figure included; no hand
    kernel launched; ms/frame."""
    import math

    import numpy as np

    from d3roma_tpu_torch.utils.exr import read_exr
    from d3roma_tpu_torch.utils.png import read_png

    out_dir = os.path.join(tmp, "eval_out")
    t0 = time.perf_counter()
    proc = _syn_child(tmp, repo, "--synthetic-eval", "eval",
                      [f"task={SYN_EVAL_PRESET}", "task.resume_pretrained=run/best",
                       "task.plot_intermediate_metrics=true", f"task.eval_output={out_dir}"])
    rc = proc.wait(timeout=900)
    seconds = time.perf_counter() - t0
    with open(os.path.join(tmp, "eval.out")) as f:
        output = f.read()
    if rc != 0:
        raise AssertionError(f"synthetic: evaluate entry point failed ({rc}): {output[-4000:]}")
    lines = [json.loads(x) for x in output.splitlines() if x.startswith('{"dataset"')]
    if len(lines) != 1 or lines[0]["dataset"] != "HISS":
        raise AssertionError(f"synthetic: evaluate printed {lines}")
    metrics = lines[0]["metrics"]
    values = [v for group in metrics.values() for v in group.values()]
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"synthetic: evaluate metrics not finite: {metrics}")
    with open(os.path.join(tmp, "eval_record.json")) as f:
        record = json.load(f)
    if any(record["launches"].values()):
        raise AssertionError(f"synthetic: hand kernels launched in the eval: {record['launches']}")
    art = os.path.join(out_dir, "HISS")
    names = sorted(os.listdir(art))
    frames = SYN_SURFACES * SYN_EVAL_FRAMES
    want = ({f"idx0_{b}_pred_disp.png" for b in range(frames)}
            | {f"idx0_{b}_simDepthImage.exr" for b in range(frames)}
            | {"idx0_error.png", "idx0_denoised.png", "idx0_intermediate_metrics.png"})
    if not want <= set(names):
        raise AssertionError(f"synthetic: evaluate artifacts {names}")
    for name in names:
        path = os.path.join(art, name)
        if name.endswith(".png"):
            arr = read_png(path)
        elif name.endswith(".exr"):
            arr = read_exr(path)
        else:
            continue
        if not np.isfinite(arr).all():
            raise AssertionError(f"synthetic: {name} not finite")
    figure = read_png(os.path.join(art, "idx0_intermediate_metrics.png"))
    if figure.shape != (240, 640, 3) or not (figure != 255).any(axis=-1).any():
        raise AssertionError(f"synthetic: intermediate-metrics figure {figure.shape}")
    (call,) = record["calls"]
    ms_per_frame = call["wall_ms"] / call["frames"]
    print(f"synthetic: evaluate entry point ({SYN_EVAL_PRESET}, {frames} rendered test frames, "
          f"my_ddpm 8 steps, dynamic thresholding, plot_intermediate_metrics) exit 0 in "
          f"{seconds:.1f} s; {ms_per_frame:.1f} ms/frame (evaluate_dataset's wall, the first "
          f"call's warm-up and the artifacts included); metrics {json.dumps(metrics)}; "
          f"{len(names)} artifacts read back, the intermediate-metrics figure {figure.shape}; "
          f"hand-kernel launches 0", flush=True)
    return dict(wall_s=seconds, ms_per_frame=ms_per_frame, metrics=metrics,
                artifacts=len(names), launches=record["launches"])


def synthetic_card_vs_cpu() -> dict:
    """One fp32 train step of a narrow pixel model (UNet2D, widths
    SYN_NARROW_WIDTHS, the preset's left+right+raw, sample prediction and
    pyramid noise) on the card and on the CPU from the same weights, batch
    and draws (recorded on the CPU, replayed on the card); the card's step
    under set_sync_debug_mode("error"). Held to the train phase's
    tolerances."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.config import load_task_preset
    from d3roma_tpu_torch.training import (
        build_models,
        build_optimizer,
        create_train_state,
        make_train_step,
    )
    from d3roma_tpu_torch.ops.noise import GeneratorDraws
    from d3roma_tpu_torch.training.train_loop import fp32_math

    cfg = load_task_preset(SYN_TRAIN_PRESET)
    cfg.block_out_channels = list(SYN_NARROW_WIDTHS)
    sd = build_models(cfg, 0, "cpu")["unet"].state_dict()
    rs = np.random.RandomState(4)
    b, (h, w) = 2, SYN_NARROW_HW
    disp = rs.uniform(-0.9, 0.9, (b, h, w, 1)).astype(np.float32)
    batch = {"normalized_disp": disp,
             "sim_disp": np.clip(disp + 0.05 * rs.standard_normal(disp.shape), -1, 1),
             "normalized_rgb": rs.uniform(-1, 1, (b, h, w, 3)),
             "left_image": rs.uniform(-1, 1, (b, h, w, 3)),
             "right_image": rs.uniform(-1, 1, (b, h, w, 3)),
             "mask": (rs.rand(b, h, w, 1) > 0.2)}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch.items()}

    def step(device, draws):
        unet = build_models(cfg, 0, device)["unet"]
        unet.load_state_dict(sd)
        opt = build_optimizer(cfg, 3, list(unet.parameters()))
        state = create_train_state(cfg, unet, 3, optimizer=opt)
        fn = make_train_step(cfg, unet, opt, cfg.schedule_config(train=True).tables(device))
        on = {k: v.to(device) for k, v in batch.items()}
        if device != "cpu":
            _sync()
            torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = fn(state, on, draws)
        finally:
            if device != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        return ({k: v.detach().cpu() for k, v in metrics.items()},
                {k: v.detach().cpu() for k, v in unet.state_dict().items()})

    rec = _Recorded(GeneratorDraws(torch.Generator().manual_seed(5)))
    cpu, cpu_sd = step("cpu", rec)
    tape = [t.to("cuda") for t in rec.tape]
    with fp32_math(torch.device("cuda")):
        card, card_sd = step("cuda", _Recorded(tape=tape))
    rel = {k: abs(float(card[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-30)
           for k in ("loss", "grad_norm")}
    worst, q999 = _param_diffs(card_sd, cpu_sd)
    lr = cfg.learning_rate
    print(f"synthetic: narrow pixel step card vs CPU (UNet2D {SYN_NARROW_WIDTHS}, conv_in "
          f"{tuple(sd['conv_in.weight'].shape)}, batch {b} at {h}x{w}): loss "
          f"{float(card['loss']):.7f} / {float(cpu['loss']):.7f} rel {rel['loss']:.2e} (tol "
          f"{TRAIN_LOSS_REL_TOL}); grad_norm rel {rel['grad_norm']:.2e} (tol "
          f"{TRAIN_GRAD_NORM_REL_TOL}); params max |diff| {worst:.3e} (tol {2 * lr:.1e}), 99.9% "
          f"{q999:.3e} (tol {1e-3 * lr:.1e}); no host sync in the card's step", flush=True)
    if not (torch.equal(card["timesteps"], cpu["timesteps"])
            and rel["loss"] <= TRAIN_LOSS_REL_TOL and rel["grad_norm"] <= TRAIN_GRAD_NORM_REL_TOL
            and worst <= 2 * lr and q999 <= 1e-3 * lr):
        raise AssertionError(f"synthetic: narrow step card vs CPU {rel} {worst} {q999}")
    return dict(rel, params_max_abs=worst, params_q999=q999)


def _syn_camera_test(tmp: str, repo: str) -> dict:
    """`python -m d3roma_tpu_torch.camera_test --replay assets/examples`:
    two threads of SYN_CAMERA_FRAMES frames of the bundled capture."""
    rc, stdout, seconds = _run_module(tmp, repo, "d3roma_tpu_torch.camera_test", "--replay",
                                      os.path.join(repo, "assets", "examples"), "--frames",
                                      str(SYN_CAMERA_FRAMES))
    import re

    lines = stdout.strip().splitlines()
    # the two threads' prints may share a line
    frames = re.findall(r"\[t[01]\] frame \d+: \(360, 640, 3\) \(360, 640\) ", stdout)
    if (rc != 0 or len(frames) != 2 * SYN_CAMERA_FRAMES or stdout.count("] frame ") != len(frames)
            or not lines[-1].startswith("mean latency:")):
        raise AssertionError(f"synthetic: camera_test ({rc}) printed {stdout[-2000:]}")
    mean_ms = float(lines[-1].split()[2])
    print(f"synthetic: camera_test --replay assets/examples exit 0 in {seconds:.1f} s: "
          f"{len(frames)} frames on two threads, {lines[-1]}", flush=True)
    return dict(wall_s=seconds, frames=len(frames), mean_latency_ms=mean_ms)


class _Beside:
    """fn(*args) on a thread; result() joins it and returns its value or
    raises its error."""

    def __init__(self, fn, *args):
        import threading

        self._out, self._error = None, None

        def run():
            try:
                self._out = fn(*args)
            except BaseException as e:  # raised by result()
                self._error = e

        self._thread = threading.Thread(target=run)
        self._thread.start()

    def result(self):
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._out


def synthetic_phase(tmp=None, prepared=None) -> dict:
    """The reference's synthetic-data workflow on the card's machine: render
    (three splits, side by side), sim depth by the stereo CLI, the train_hiss
    entry point (with the narrow card-vs-CPU step and camera_test beside it),
    then the eval_his_sim entry point on best/, started once best/ is
    exported, beside the train process's checkpoint write. The whole pass
    renders and runs the stereo CLI into `tmp` beside the mono phase's
    processes (`prepared`, a `_Beside` of `_syn_prepare`: host work, and
    about 0.25 s of the card's); alone the phase does that first.

    Cut from the presets: 16 rendered train frames weighted 6 (3 steps of
    batch 32 in one epoch; the preset trains 200 epochs on the HISS set),
    the in-training eval at step 3 (every 5000) on one batch of the 4 val
    frames, the preset's epoch export not reached (save_model_epochs 5),
    the eval on 4 rendered test frames; the models from seeded random
    weights. Widths, image size, batch, precision, conditions, prediction
    type, noise and the eval's sampler are the presets'."""
    repo = os.path.dirname(os.path.abspath(__file__))
    if tmp is None:
        import tempfile

        with tempfile.TemporaryDirectory() as own:
            return synthetic_phase(own, _Beside(_syn_prepare, own, repo))
    summary = prepared.result()
    steps = SYN_WEIGHT * SYN_SURFACES * SYN_TRAIN_FRAMES // 32
    t0 = time.perf_counter()
    proc = _syn_child(tmp, repo, "--synthetic-train", "train",
                      [f"task={SYN_TRAIN_PRESET}", f"task.dataset_weight=[{SYN_WEIGHT}]",
                       "task.num_epochs=1", f"task.val_every_global_steps={steps}",
                       "task.eval_num_batch=1", "task.output_dir=run"])
    evaluate = None
    try:
        summary["card_vs_cpu"] = synthetic_card_vs_cpu()
        summary["camera_test"] = _syn_camera_test(tmp, repo)
        _wait_for_best(tmp, proc, "synthetic")
        if proc.poll() is None or proc.returncode == 0:
            evaluate = _Beside(_syn_eval, tmp, repo)
        summary["train"] = _syn_train_finish(tmp, proc, t0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if evaluate is not None:
            summary["eval"] = evaluate.result()
    return summary


IMPORT_HW = (360, 640)
IMPORT_STEPS = 3  # the latency calls' (fewer than the preset's 10: the pass's time limit)
IMPORT_STATIC_STEPS = 2  # the calibrated throughput calls'
# The guided latency call through the kernels against the same call through
# their plain versions, max |a - b| / max |b| of the images: the bf16
# kernels' rule of the eval and serve phases (UNET_REL_TOL); the same call
# on other noise must land outside it.
IMPORT_PRED_REL_TOL = UNET_REL_TOL
# The text embedding on the card against the plain CPU forward of the tower
IMPORT_EMBED_REL_TOL = 1e-4
# SD2.1's diffusers configs (stabilityai/stable-diffusion-2-1: unet/, vae/,
# text_encoder/ and scheduler/ config.json, the fields the importers read)
SD21_UNET = {"_class_name": "UNet2DConditionModel", "in_channels": 4, "out_channels": 4,
             "block_out_channels": [320, 640, 1280, 1280],
             "attention_head_dim": [5, 10, 20, 20], "cross_attention_dim": 1024,
             "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                                  "CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                "CrossAttnUpBlock2D"],
             "layers_per_block": 2, "norm_num_groups": 32, "use_linear_projection": True}
SD21_VAE = {"_class_name": "AutoencoderKL", "latent_channels": 4,
            "block_out_channels": [128, 256, 512, 512], "norm_num_groups": 32}
SD21_TEXT = {"architectures": ["CLIPTextModel"], "vocab_size": 49408, "hidden_size": 1024,
             "intermediate_size": 4096, "num_hidden_layers": 23, "num_attention_heads": 16,
             "max_position_embeddings": 77, "hidden_act": "gelu", "torch_dtype": "float32"}
SD21_SCHEDULER = {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000,
                  "beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
                  "prediction_type": "v_prediction", "clip_sample": False,
                  "set_alpha_to_one": False, "steps_offset": 1}
_ST_DTYPES = {"float32": "F32", "float16": "F16", "int64": "I64"}


def _write_safetensors(path, tensors) -> None:
    """A .safetensors file: the 8-byte header length, the JSON header
    (padded to 8 bytes), then each tensor's bytes in order."""
    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(-1).view(torch.uint8).numpy())


def _write_sd21(ref, gen):
    """A bare SD2.1 diffusers directory with weights random from `gen`: the
    4-channel UNet in fp16 safetensors, the VAE in fp32 .bin, the 23-layer
    text tower in fp32 safetensors (transformers' names and position_ids
    buffer), a DDIM scheduler. Returns the source state dicts."""
    import torch

    from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition, init_random_
    from d3roma_tpu_torch.models.clip_text import CLIPTextModel

    for sub, cfg in (("unet", SD21_UNET), ("vae", SD21_VAE), ("text_encoder", SD21_TEXT),
                     ("scheduler", SD21_SCHEDULER)):
        os.makedirs(os.path.join(ref, sub))
        name = "scheduler_config.json" if sub == "scheduler" else "config.json"
        with open(os.path.join(ref, sub, name), "w") as f:
            json.dump(cfg, f)
    unet = {k: v.half().cpu() for k, v in init_random_(
        UNet2DCondition(in_channels=4, out_channels=4, device="cuda"), gen).state_dict().items()}
    _write_safetensors(os.path.join(ref, "unet", "diffusion_pytorch_model.safetensors"), unet)
    vae = {k: v.cpu() for k, v in init_random_(AutoencoderKL(device="cuda"),
                                               gen).state_dict().items()}
    torch.save(vae, os.path.join(ref, "vae", "diffusion_pytorch_model.bin"))
    text = {k: v.cpu() for k, v in init_random_(CLIPTextModel(device="cuda"),
                                                gen).state_dict().items()}
    tensors = {f"text_model.{k}": v for k, v in text.items()}
    tensors["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    _write_safetensors(os.path.join(ref, "text_encoder", "model.safetensors"), tensors)
    return unet, vae, text


def _run_module(tmp, repo, module, *argv, timeout=900):
    """`python -m module argv...` in its own process; (returncode, stdout,
    seconds)."""
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
    return proc.returncode, proc.stdout, seconds


def _check_imported(out, unet, vae, text):
    """Every imported tensor equal to its source (in the source's dtype, as
    the JAX importer holds it), conv_in the fp32 widening, the text
    embedding within IMPORT_EMBED_REL_TOL of the plain CPU forward of the
    same tower. Returns (conv_in max |err|, embedding rel)."""
    import numpy as np
    import torch

    from d3roma_tpu_torch.models import flax_unet_to_torch, flax_vae_to_torch
    from d3roma_tpu_torch.models.clip_text import CLIPTextModel, empty_prompt_tokens
    from d3roma_tpu_torch.utils import flax_msgpack

    for name, src, to_torch in (("unet", unet, flax_unet_to_torch),
                                ("vae", vae, flax_vae_to_torch)):
        got = to_torch(flax_msgpack.load(os.path.join(out, name, "params.msgpack")))
        if set(got) != set(src):
            raise AssertionError(f"import: {name} names differ: {sorted(set(got) ^ set(src))}")
        for k, v in src.items():
            want = v
            if k in ("conv_in.weight", "conv_in.bias") and name == "unet":
                w = v.float().repeat(1, 3, 1, 1) if k.endswith("weight") else v.float()
                want = (w / 3).to(v.dtype)
            if got[k].dtype != want.dtype or not torch.equal(got[k], want):
                raise AssertionError(f"import: {name}.{k} differs from its source")
    print("import: every UNet (fp16) and VAE (fp32) tensor equal to its source; conv_in "
          "bit-equal to repeat(1, 3, 1, 1) / 3 in fp32", flush=True)
    embed = np.load(os.path.join(out, "text_embed.npy"))
    cpu = CLIPTextModel(device="cpu")
    cpu.load_state_dict(text)
    with torch.no_grad():
        ref = cpu(torch.from_numpy(empty_prompt_tokens()).long()).numpy()
    rel = float(np.abs(embed - ref).max() / np.abs(ref).max())
    print(f"import: text embedding {embed.shape} {embed.dtype} on the card against the CPU "
          f"forward: max |a - b| / max |b| = {rel:.3e} (tol {IMPORT_EMBED_REL_TOL})",
          flush=True)
    if embed.shape != (1, 2, 1024) or embed.dtype != np.float32 or not rel <= IMPORT_EMBED_REL_TOL:
        raise AssertionError(f"import: text embedding {embed.shape} {embed.dtype}, rel {rel}")
    return rel


def import_phase():
    """Reference checkpoints on the card, hermetic, in a temporary directory:

    - a bare SD2.1 diffusers directory at full width, weights random from a
      seed (`_write_sd21`): the 4-channel UNet in fp16 safetensors, the VAE
      in fp32 .bin, the text tower in fp32 safetensors, a DDIM v-prediction
      scheduler;
    - `python -m d3roma_tpu_torch.import_reference REF OUT --cond-channels
      rgb+raw` in its own process, timed; every imported tensor equal to its
      source, conv_in the fp32 widening bit for bit, the [1, 2, 1024] text
      embedding within IMPORT_EMBED_REL_TOL of the CPU forward;
    - meanwhile, `python -m d3roma_tpu_torch.parity_check --ref-dir REF` at
      64x96, 2 steps, one batch of 2 frames (exit 0, parity.json written),
      and `--golden-dump` then `--golden-compare` on OUT (every stage
      matching), each its own process; the in-process checks below run
      beside the golden ones (so their ms/request is not a lone run's);
    - the imported pipeline under fast_inference("latency"), batch 1, RGB +
      raw at 360x640, IMPORT_STEPS DDIM steps: unguided and guided
      (gradient mode, 10 Adam steps at lr 1e-3, the raw disparity with 10%
      holes through the pipeline's denormalizer), each 10 whole-row
      attention and 16 GEGLU launches a step; the guided images against the same call through the
      kernels' plain versions within IMPORT_PRED_REL_TOL (another seed
      outside it) and different from the unguided ones; ms/request of both
      and the guided call's peak memory;
    - the same models under fast_inference("throughput"), calibrated on one
      batch, IMPORT_STATIC_STEPS steps: the guided images bit-equal to the
      unguided ones (the gradient through static int8 is zero), the guided
      call's extra launches those of IMPORT_STATIC_STEPS x 10 decodes;
    - a decode's latent gradient with the VAE under "dense" (4 dynamic int8
      launches) through the kernels within REL_TOL of the plain versions',
      and under True the int8 whole-row attention refusing the gradient.

    Returns a summary dict."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from d3roma_tpu_torch.guidance import FlowGuidance, frozen_parameters, grad_of
    from d3roma_tpu_torch.models import decode_latent
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline

    summary = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ref, out = os.path.join(tmp, "sd21"), os.path.join(tmp, "imported")
        t0 = time.perf_counter()
        unet, vae, text = _write_sd21(ref, torch.Generator(device="cuda").manual_seed(16))
        torch.cuda.empty_cache()
        print(f"import: SD2.1 directory written in {time.perf_counter() - t0:.1f}s", flush=True)
        children = {}

        def parity():  # reads only the reference directory: beside the import
            children["parity"] = _run_module(
                tmp, repo, "d3roma_tpu_torch.parity_check", "--ref-dir", ref, "--out-dir",
                os.path.join(tmp, "parity"), "--image-size", "64x96", "--steps", "2",
                "--max-batches", "1", "--frames", "2")

        def golden():
            gold = os.path.join(tmp, "golden")
            for flag in ("--golden-dump", "--golden-compare"):
                children[flag[2:]] = _run_module(tmp, repo, "d3roma_tpu_torch.parity_check",
                                                 "--pipeline-dir", out, flag, gold)

        def pipeline_checks():
            pipe = GuidedLatentDiffusionPipeline.from_pretrained(out, device="cuda")
            pipe.fast_inference("latency")
            gen = torch.Generator(device="cuda").manual_seed(17)
            h, w = IMPORT_HW
            rgb = torch.rand((1, h, w, 3), generator=gen, device="cuda") * 2 - 1
            disp = 10 + 50 * torch.rand((1, h, w, 1), generator=gen, device="cuda")
            disp = torch.where(torch.rand(disp.shape, generator=gen, device="cuda") < 0.1,
                               torch.zeros_like(disp), disp)
            sim = pipe.normalizer.normalize(disp)[0]
            guidance = FlowGuidance(flow_guidance_weight=1.0, flow_guidance_mode="gradient")

            def call(steps, guided, seed=23):
                pipe.guidance = guidance if guided else None
                kw = dict(raw_depth=disp, denormer=pipe.normalizer.denormalize) if guided else {}
                return pipe(num_inference_steps=steps, num_intermediate_images=1,
                            cond_channels="rgb+raw", rgb_images=rgb, sim_disp=sim,
                            generator=torch.Generator(device="cuda").manual_seed(seed), **kw).images

            bf16 = {"attention": 10 * IMPORT_STEPS, "geglu": 16 * IMPORT_STEPS}
            call(IMPORT_STEPS, False)  # warm
            _sync()
            outs = {}
            for guided in (False, True):
                kind = "guided" if guided else "unguided"
                torch.cuda.reset_peak_memory_stats()
                summary[f"launches_latency_{kind}"] = _serve_counts(
                    f"import latency {kind}",
                    lambda: outs.setdefault(guided, call(IMPORT_STEPS, guided).float()), bf16)
                peak = torch.cuda.max_memory_allocated() / 2**30
                ms, walls = _median_ms(lambda: call(IMPORT_STEPS, guided), 1,
                                       reps=1 if guided else 2)
                print(f"import latency {kind}: {ms:.2f} ms/request (batch 1, {IMPORT_STEPS} "
                      f"steps, {h}x{w}, median of {[round(x, 2) for x in walls]}), peak memory "
                      f"{peak:.2f} GiB", flush=True)
                summary[f"ms_per_request_{kind}"] = ms
                summary[f"peak_gib_{kind}"] = peak
            moved = (outs[True] - outs[False]).abs().max().item()
            print(f"import: guided against unguided images, max |a - b| = {moved:.4e} (must be "
                  f"above 0: the gradient reached the latent)", flush=True)
            if not moved > 0:
                raise AssertionError("import: guided latency call equals the unguided one")
            summary["guided_moved"] = moved

            fast = outs[True]
            plain = _plain_bf16(lambda: call(IMPORT_STEPS, True)).float()
            control = _plain_bf16(lambda: call(IMPORT_STEPS, True, seed=24)).float()
            scale = plain.abs().max().item()
            rel = (fast - plain).abs().max().item() / scale
            control_rel = (control - plain).abs().max().item() / scale
            print(f"import latency guided: images through the kernels against their plain "
                  f"versions max |a - b| / max |b| = {rel:.3e} (tol {IMPORT_PRED_REL_TOL}); plain "
                  f"on other noise {control_rel:.3e} (must exceed the tol)", flush=True)
            if not (rel <= IMPORT_PRED_REL_TOL < control_rel):
                raise AssertionError(f"import: guided kernels against plain {rel}, control "
                                     f"{control_rel} (tol {IMPORT_PRED_REL_TOL})")
            summary.update(guided_rel=rel, guided_control_rel=control_rel)

            # static int8: calibrated on one batch; the guidance is a no-op
            pipe.guidance = None
            pipe.fast_inference("throughput").calibrate(
                gen, [dict(rgb_images=rgb, sim_disp=sim)], cond_channels="rgb+raw",
                num_inference_steps=IMPORT_STATIC_STEPS)
            call(IMPORT_STATIC_STEPS, False)
            _sync()
            decode = pipe._replayed(lambda z: decode_latent(pipe.vae, z), "vae_decode")
            _zero_launches()
            with torch.no_grad():
                decode(torch.randn((1, h // 8, w // 8, 4), generator=gen, device="cuda"))
            _sync()
            per_decode = {k: v for k, v in _int8_launches().items() if v}
            counts, images = {}, {}
            for guided in (False, True):
                _zero_launches()
                images[guided] = call(IMPORT_STATIC_STEPS, guided)
                _sync()
                counts[guided] = _int8_launches()
            extra = {k: counts[True][k] - counts[False][k] for k in counts[True]}
            want = {k: IMPORT_STATIC_STEPS * guidance.num_opt_steps * per_decode.get(k, 0)
                    for k in extra}
            same = torch.equal(images[True], images[False])
            print(f"import throughput: one decode launches {per_decode}; guided call's extra "
                  f"launches {({k: v for k, v in extra.items() if v})} (expected "
                  f"{IMPORT_STATIC_STEPS} x {guidance.num_opt_steps} decodes); guided images "
                  f"bit-equal to unguided: {same}", flush=True)
            if extra != want or not same:
                raise AssertionError(f"import throughput: extra launches {extra} (want {want}), "
                                     f"bit-equal {same}")
            summary["launches_throughput_guided"] = {k: v for k, v in counts[True].items() if v}

            # the dynamic int8 op's gradient (ops/quant.py::_DynamicInt8): the
            # latent gradient of a decode under "dense" (the VAE attention's four
            # projections dynamic int8, float elsewhere) through the kernels
            # against their plain versions; under True the int8 whole-row
            # attention refuses a gradient, as the JAX package's kernel does
            z = torch.randn((1, h // 8, w // 8, 4), generator=gen, device="cuda")

            def latent_grad():
                with frozen_parameters(pipe.vae):
                    return grad_of(lambda latent: decode_latent(pipe.vae, latent).float().mean(), z)

            pipe.vae.set_quant("dense")
            _zero_launches()
            g_fast = latent_grad()
            _sync()
            dense_launches = _int8_launches()["conv2d_int8_dynamic"]
            g_plain = _plain_int8_forward(latent_grad, attention=False)
            g_rel = (g_fast - g_plain).abs().max().item() / max(g_plain.abs().max().item(), 1e-30)
            pipe.vae.set_quant(True)
            try:
                latent_grad()
                refused = None
            except RuntimeError as e:
                refused = str(e)
            print(f"import dynamic int8 gradient: {dense_launches} dynamic int8 launches in a "
                  f"decode; latent gradient through the kernels against the plain versions max "
                  f"|a - b| / max |b| = {g_rel:.3e} (tol {REL_TOL}), max |g| "
                  f"{g_plain.abs().max().item():.3e}; under True: {refused}", flush=True)
            if not (dense_launches == 4 and g_rel <= REL_TOL and g_plain.abs().max() > 0
                    and refused and "has no gradient" in refused):
                raise AssertionError(f"import: dynamic int8 gradient {dense_launches} launches, "
                                     f"rel {g_rel}, refusal {refused!r}")
            summary.update(dynamic_grad_rel=g_rel)
            del pipe
            torch.cuda.empty_cache()

        sides = [threading.Thread(target=parity)]
        sides[0].start()
        try:
            rc, stdout, seconds = _run_module(tmp, repo, "d3roma_tpu_torch.import_reference",
                                              ref, out, "--cond-channels", "rgb+raw")
            print(f"import: python -m d3roma_tpu_torch.import_reference exit {rc} in "
                  f"{seconds:.1f}s: {stdout.strip().splitlines()}", flush=True)
            if rc != 0:
                raise AssertionError(f"import: import_reference exited {rc}")
            summary["import_s"] = seconds
            sides.append(threading.Thread(target=golden))
            sides[1].start()
            summary["embed_rel"] = _check_imported(out, unet, vae, text)
            del unet, vae, text
            pipeline_checks()  # beside the parity_check processes, which only read files
        finally:
            for side in sides:
                side.join()
        if set(children) != {"parity", "golden-dump", "golden-compare"}:
            raise AssertionError(f"import: parity_check runs missing: {sorted(children)}")
        for name, (rc, stdout, seconds) in children.items():
            print(f"import: parity_check {name} exit {rc} in {seconds:.1f}s: "
                  f"{stdout.strip().splitlines()[-1:]}", flush=True)
        if any(rc != 0 for rc, _, _ in children.values()):
            raise AssertionError(f"import: a parity_check run failed "
                                 f"{ {k: v[0] for k, v in children.items()} }")
        with open(os.path.join(tmp, "parity", "parity.json")) as f:
            summary["parity_rel"] = json.load(f)["rel"]
        if "GOLDEN COMPARE: all stages match" not in children["golden-compare"][1]:
            raise AssertionError("import: the golden compare did not match every stage")

    return summary


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


TP_RANKS = 2
# the compositions' flagship batch-1 shapes: attention (B, N, H, D, int8), the
# VAE's 512-wide head in int8 only; GEGLU rows x C x F at the UNet's levels
TP_ATTENTION_SHAPES = ((1, 3600, 5, 64, False), (1, 920, 10, 64, False),
                       (1, 3600, 5, 64, True), (1, 920, 10, 64, True),
                       (1, 3600, 1, 512, True))
TP_GEGLU_SHAPES = ((3600, 320, 1280), (920, 640, 2560), (240, 1280, 5120), (60, 1280, 5120))
TP_SEED = 41
TP_STEPS = 1  # a TP request's denoise steps (fewer than the preset's 10: the pass's time limit)


def _tp_launches():
    from d3roma_tpu_torch.ops.kernels import geglu_ff_tp, mha_attention_tp

    return dict(_int8_launches(), attention_tp=mha_attention_tp.launches,
                geglu_tp=geglu_ff_tp.launches)


def _tp_zero_launches():
    from d3roma_tpu_torch.ops.kernels import geglu_ff_tp, mha_attention_tp

    _zero_launches()
    mha_attention_tp.launches = geglu_ff_tp.launches = 0


def _tp_time(fn, reps: int = 5, warmup: int = 2) -> float:
    """time_ms(fn) with the ranks in step: each starts after the other has
    finished its work before (a collective would otherwise wait for it)."""
    import torch.distributed as dist

    _sync()
    dist.barrier()
    return time_ms(fn, reps, warmup)


def _tp_attention_case(mesh, b, n, h, d, int8, gen):
    """mha_attention_tp on this rank against its plain composition; the
    composition's ms, its kernel's (this rank's q rows against the whole
    K/V) and its gather's, the plain composition's, SDPA's on the rank's
    rows, and the bound of the rank's share of the work."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.ops.kernels import (
        mha_attention, mha_attention_int8, mha_attention_tp, mha_attention_tp_plain)
    from d3roma_tpu_torch.parallel import MODEL_AXIS, all_gather_cat

    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    quant = "int8" if int8 else None
    out = mha_attention_tp(q, k, v, mesh, quant=quant)
    ref = mha_attention_tp_plain(q, k, v, mesh, quant=quant)
    err = (out.float() - ref.float()).abs().max().item()
    rows = n // mesh.axis_sizes[MODEL_AXIS]
    i = mesh.coord(MODEL_AXIS)
    ql = q[:, i * rows:(i + 1) * rows]
    kernel = mha_attention_int8 if int8 else mha_attention
    local = kernel(ql, k, v)
    row = dict(shape=f"B{b} N{n} H{h} D{d} {'int8' if int8 else 'bf16'}, {rows} q rows a rank",
               max_abs_err=err,
               ms=_tp_time(lambda: mha_attention_tp(q, k, v, mesh, quant=quant)),
               kernel_ms=_tp_time(lambda: kernel(ql, k, v)),
               collective_ms=_tp_time(lambda: all_gather_cat(local, mesh, MODEL_AXIS, 1)),
               plain_ms=_tp_time(lambda: mha_attention_tp_plain(q, k, v, mesh, quant=quant),
                                reps=2, warmup=1))
    qh, kh, vh = (t.transpose(1, 2) for t in (ql, k, v))
    row["library_ms"] = _tp_time(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    row["library_call"] = "SDPA bf16 on the rank's q rows"
    nbytes = (ql.numel() + k.numel() + v.numel() + local.numel()) * 2
    row["bound_ms"], row["bound_by"] = bound(4.0 * b * h * rows * n * d, nbytes,
                                             H100_INT8_OPS if int8 else H100_BF16_FLOPS,
                                             exps=float(b * h * rows * n))
    return _check_row("mha_attention_tp", row, err, REL_TOL * ref.float().abs().max().item())


def _tp_geglu_case(mesh, rows, c, f, int8, gen):
    """geglu_ff_tp on this rank's F chunk against its plain composition
    (the int8 one bit-equal: the kernel is, and the sum is the same); the
    composition's ms, its kernel's on the chunk and its all-reduce's, the
    plain composition's, two bf16 linears and the gelu on the chunk, and
    the bound of the rank's share."""
    import torch
    import torch.nn.functional as F

    from d3roma_tpu_torch.models.layers import FeedForward
    from d3roma_tpu_torch.ops.kernels import (
        geglu_ff, geglu_ff_int8, geglu_ff_tp, geglu_ff_tp_plain)
    from d3roma_tpu_torch.parallel import MODEL_AXIS, all_reduce

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    tp, i = mesh.axis_sizes[MODEL_AXIS], mesh.coord(MODEL_AXIS)
    x = randn(1, rows, c)
    w1h, w1g, w2 = randn(f, c, scale=c ** -0.5), randn(f, c, scale=c ** -0.5), \
        randn(c, f, scale=f ** -0.5)
    b1h, b1g, b2 = randn(f, scale=0.1), randn(f, scale=0.1), randn(c, scale=0.1)
    fl = f // tp
    part = (w1h[i * fl:(i + 1) * fl], w1g[i * fl:(i + 1) * fl],
            w2[:, i * fl:(i + 1) * fl].contiguous(), b1h[i * fl:(i + 1) * fl],
            b1g[i * fl:(i + 1) * fl], b2)
    if int8:
        ops = FeedForward._make_int8_operands(*part)
        scale = x.float().abs().max().item() / 127.0
        chunk, args = ops[:8], (ops[8], mesh, scale)
        zeros = torch.zeros(c, dtype=torch.float32, device="cuda")

        def kernel():
            return geglu_ff_int8(x, *chunk, zeros, scale)
    else:
        ops = FeedForward._make_operands(*part)
        chunk, args = ops[:5], (ops[5], mesh)

        def kernel():
            return geglu_ff(x, *chunk)
    out = geglu_ff_tp(x, chunk, *args)
    ref = geglu_ff_tp_plain(x, chunk, *args)
    err = (out.float() - ref.float()).abs().max().item()
    partial = kernel()
    row = dict(shape=f"rows {rows} C{c} F{f} {'int8' if int8 else 'bf16'}, F {fl} a rank",
               max_abs_err=err, ms=_tp_time(lambda: geglu_ff_tp(x, chunk, *args)),
               kernel_ms=_tp_time(kernel),
               collective_ms=_tp_time(lambda: all_reduce(partial, mesh, MODEL_AXIS)),
               plain_ms=_tp_time(lambda: geglu_ff_tp_plain(x, chunk, *args), reps=2, warmup=1))
    w1h_r, w1g_r, w2_r, b1h_r, b1g_r = part[:5]
    row["library_ms"] = _tp_time(lambda: F.linear(
        F.linear(x, w1h_r, b1h_r) * F.gelu(F.linear(x, w1g_r, b1g_r), approximate="tanh"),
        w2_r))
    row["library_call"] = "2 bf16 linears + gelu on the rank's chunk"
    wbytes = 1 if int8 else 2
    nbytes = 2 * rows * c * 2 + 3 * c * fl * wbytes
    row["bound_ms"], row["bound_by"] = bound(6.0 * rows * c * fl, nbytes,
                                             H100_INT8_OPS if int8 else H100_BF16_FLOPS)
    return _check_row("geglu_ff_tp", row, err,
                      0.0 if int8 else REL_TOL * ref.float().abs().max().item())


def _tp_depth_check(label, rel, tol):
    print(f"{label}: max |a - b| / max |b| of the disparity {rel:.3e} (tol {tol:.3e})",
          flush=True)
    if not rel <= tol:
        raise AssertionError(f"{label}: {rel} > {tol}")
    return rel


def _tp_plain(fn):
    """fn() with the layers' compositions replaced by their plain versions."""
    from d3roma_tpu_torch.models import layers
    from d3roma_tpu_torch.ops import kernels

    saved = layers.mha_attention_tp, layers.geglu_ff_tp
    layers.mha_attention_tp = kernels.mha_attention_tp_plain
    layers.geglu_ff_tp = kernels.geglu_ff_tp_plain
    try:
        return fn()
    finally:
        layers.mha_attention_tp, layers.geglu_ff_tp = saved


def tp_rank_main(spec_path: str) -> int:
    """One rank of the tensor-parallel phase, as `torchrun --nproc-per-node
    2 chip_smoke.py --tp-rank SPEC` starts it: both ranks on the one card
    (gloo). Writes its results to SPEC's directory as rank<r>.json, and a
    failure's traceback to stdout. SPEC (JSON): max_sm_clock_mhz; for a
    rehearsal on the CPU also pipe_dir (a small pipeline to load in place of
    the full-width one `_tp_pipeline` builds), device "cpu", compositions
    false (the flagship shapes' cases skipped) and expect, the launch counts
    of a call by mode (else the SD2.1 UNet's)."""
    try:
        return _tp_rank(spec_path)
    except BaseException:
        import traceback

        print(f"tp rank failed:\n{traceback.format_exc()}", flush=True)
        raise


def _tp_pipeline(cfg, device):
    """The phase's full-width rgb+raw pipeline: SD2.1 geometry, random weights
    from seed 0 (the same on every rank), in bf16, the preset's sampler and
    normalizer."""
    import torch

    from d3roma_tpu_torch.guidance import FlowGuidance
    from d3roma_tpu_torch.models import (
        AutoencoderKL, UNet2DCondition, init_random_, widened_in_channels)
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec

    gen = torch.Generator(device=device).manual_seed(0)
    return GuidedLatentDiffusionPipeline(
        unet=init_random_(UNet2DCondition(in_channels=widened_in_channels("rgb+raw"),
                                          out_channels=4, device=device), gen),
        vae=init_random_(AutoencoderKL(device=device), gen),
        text_embed=torch.zeros(1, 2, 1024), spec=create_sampler_spec(cfg, train=False),
        normalizer=Normalizer.from_config(cfg), guidance=FlowGuidance(flow_guidance_weight=0.0),
        device=device).half_precision()


def _tp_rank(spec_path: str) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from d3roma_tpu_torch.config import compose
    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.parallel import (
        MODEL_AXIS, all_gather_cat, broadcast_object, init_distributed, make_mesh_dp_tp,
        param_bytes)
    from d3roma_tpu_torch.parallel.mesh import COLLECTIVES
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline
    from d3roma_tpu_torch.utils.camera import Realsense

    with open(spec_path) as f:
        spec = json.load(f)
    device = init_distributed(spec.get("device"))
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world": world, "device": str(device), "backend": dist.get_backend()}
    print(f"tp rank {rank} of {world} on {device}, backend {dist.get_backend()}", flush=True)

    # (1) both compositions at the flagship batch-1 shapes
    mesh = make_mesh_dp_tp(1, world)
    if spec.get("compositions", True):
        gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
        _CARD["max_sm_clock_mhz"] = spec["max_sm_clock_mhz"]
        out["attention"] = [_tp_attention_case(mesh, *s, gen) for s in TP_ATTENTION_SHAPES]
        out["geglu"] = [_tp_geglu_case(mesh, r, c, f, i8, gen) for i8 in (False, True)
                        for r, c, f in TP_GEGLU_SHAPES]

    # (2) D3RoMa rgb+raw at full width, batch 1, 360x640, under tensor_parallel
    base = [f"task={SERVE_PRESET}", "task.image_size=[360,640]",
            "task.num_intermediate_images=1", f"task.num_inference_timesteps={TP_STEPS}"]
    cfg = compose(base).task
    steps = cfg.num_inference_timesteps
    rgb, raw = _serve_frame(30, 1.5)
    cam = Realsense.default_real("fxm")  # D3RoMa sets each its own camera's resolution
    refs = {}

    def call(d, seed):
        d._generator.manual_seed(seed)
        return d.infer_with_rgb_raw(rgb, raw)

    def same_on_ranks(label, depth):
        t = torch.from_numpy(np.ascontiguousarray(depth))[None]
        both = all_gather_cat(t, mesh, MODEL_AXIS, 0)
        if not torch.equal(both[0], both[-1]):
            raise AssertionError(f"{label}: the ranks' depths differ")

    # one pipeline: latency is fast_inference("latency"), throughput the same
    # with static int8 (what fast_inference("throughput") sets), calibrated
    t0 = time.perf_counter()
    pipe = (GuidedLatentDiffusionPipeline.from_pretrained(spec["pipe_dir"], device=device)
            if spec.get("pipe_dir") else _tp_pipeline(cfg, device)).fast_inference("latency")
    load_s = time.perf_counter() - t0
    disp = torch.from_numpy(cam.fxb_depth / raw).to(device)[None, ..., None]
    calib = [dict(rgb_images=(torch.from_numpy(rgb).to(device).float()[None] / 255.0 - 0.5)
                  * 2.0, sim_disp=pipe.normalizer.normalize(disp)[0])]
    modes = {"latency": False, "throughput": "static"}

    def set_mode(quant):
        pipe.set_quant(quant)
        if quant:
            pipe.calibrate(torch.Generator(device=device).manual_seed(5), calib,
                           cond_channels="rgb+raw", num_inference_steps=steps)

    ov = base + ["task.fast_inference=latency"]
    if rank == 0:  # the tp=1 references on the same weights, inputs and noise
        d1 = D3RoMa(ov, Realsense.default_real("fxm"), variant="rgb+raw", pipeline=pipe,
                    device=device)
        for mode, quant in modes.items():
            set_mode(quant)
            refs[mode] = call(d1, TP_SEED)
            refs[mode + "_other"] = call(d1, TP_SEED + 1)
        del d1
    dist.barrier()
    t0 = time.perf_counter()
    d2 = D3RoMa(ov + [f"task.tensor_parallel={world}"], Realsense.default_real("fxm"),
                variant="rgb+raw", pipeline=pipe, device=device)
    shard_s = time.perf_counter() - t0
    fxb = d2.camera.fxb_depth
    out["param_bytes"] = param_bytes(pipe.unet) + param_bytes(pipe.vae)
    out["param_bytes_whole"] = param_bytes(pipe.unet, whole=True) + param_bytes(pipe.vae,
                                                                                whole=True)
    print(f"tp: rank {rank} parameters {out['param_bytes'] / 2**20:.1f} MiB of "
          f"{out['param_bytes_whole'] / 2**20:.1f} MiB replicated; built {load_s:.1f}s, shard "
          f"{shard_s:.1f}s", flush=True)
    for mode, quant in modes.items():
        t0 = time.perf_counter()
        set_mode(quant)  # the throughput tables calibrated on the meshed pipeline
        calib_s = time.perf_counter() - t0
        _tp_zero_launches()
        before = dict(COLLECTIVES)
        t0 = time.perf_counter()
        fast = call(d2, TP_SEED)  # timed: the mode's first call (its weight caches built in it)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        coll = {k: COLLECTIVES[k] - before[k] for k in COLLECTIVES}
        counts = {k: v for k, v in _tp_launches().items() if v}
        expected = spec.get("expect", {}).get(mode) or (
            {"attention": 10 * steps, "geglu": 16 * steps, "attention_tp": 10 * steps,
             "geglu_tp": 16 * steps} if mode == "latency" else
            {"attention_int8": 10 * steps + 2, "geglu_int8": 16 * steps,
             "attention_tp": 10 * steps + 2, "geglu_tp": 16 * steps})
        print(f"tp {mode}: rank {rank} launches in one call {counts} (expected {expected})",
              flush=True)
        if any(counts.get(k, 0) != v for k, v in expected.items()):
            raise AssertionError(f"tp {mode}: launches {counts}, expected {expected}")
        same_on_ranks(f"tp {mode}", fast)
        plain = _tp_plain(lambda: call(d2, TP_SEED))
        res = dict(launches=counts, ms_per_request=ms, calibrate_s=calib_s,
                   collectives=dict(calls=coll["calls"], mib=coll["bytes"] / 2**20,
                                    ms=coll["seconds"] * 1e3),
                   kernels_vs_plain=_depth_rel([fast], [plain], fxb))
        if rank == 0:
            if mode == "latency":
                tol = SERVE_PRED_REL_TOL
            else:  # the int8 noise: the tp=1 call in int8 against the same call in bf16
                res["int8_noise"] = _depth_rel([refs["throughput"]], [refs["latency"]], fxb)
                tol = 2 * res["int8_noise"]
            res["tol"] = tol
            res["vs_tp1"] = _tp_depth_check(f"tp {mode}: TP{world} against tp=1",
                                            _depth_rel([fast], [refs[mode]], fxb), tol)
            res["control"] = _depth_rel([refs[mode + "_other"]], [refs[mode]], fxb)
            print(f"tp {mode}: tp=1 on other noise {res['control']:.3e} (must exceed the tol)",
                  flush=True)
            if not res["control"] > tol:
                raise AssertionError(f"tp {mode}: other noise within the tolerance")
        tol = broadcast_object(res.get("tol"), mesh)
        _tp_depth_check(f"tp {mode}: rank {rank} kernels against the plain compositions",
                        res["kernels_vs_plain"], tol)
        print(f"tp {mode}: rank {rank} {ms:.2f} ms/request, of it {res['collectives']['ms']:.1f}"
              f" ms in {coll['calls']} collectives of {res['collectives']['mib']:.1f} MiB "
              f"(this rank's); calibrate {calib_s:.1f}s", flush=True)
        out[mode] = res
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dp2_eval(tmp, repo, pipe_dir):
    """`python -m d3roma_tpu_torch.distributed_evaluate` data parallel on two
    ranks of the card (torchrun, gloo) against the one-process `python -m
    d3roma_tpu_torch.evaluate`, run at the same time, on the same 4
    procedural HISS frames under `tmp`/datasets and seed: depth/rel and
    disp/epe within EVAL_METRIC_REL_TOL. Returns the comparison and the
    one-process JSON line (`evaluate_line`)."""
    args = [f"task={EVAL_PRESET}", f"task.resume_pretrained={pipe_dir}",
            "task.eval_dataset=[HISS]", "task.fast_inference=latency",
            f"task.eval_batch_size={EVAL_BATCH}"]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = {"distributed_evaluate": subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "d3roma_tpu_torch.distributed_evaluate"] + args, cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "evaluate": subprocess.Popen(
            [sys.executable, "-m", "d3roma_tpu_torch.evaluate"] + args, cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    outs = {}
    for name, p in procs.items():
        try:
            o, e = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            o, e = p.communicate()
        if p.returncode != 0:
            raise AssertionError(f"dp2 eval: {name} exited {p.returncode}: {e[-3000:]}")
        lines = [json.loads(ln) for ln in o.splitlines() if ln.startswith('{"dataset"')]
        if len(lines) != 1:
            raise AssertionError(f"dp2 eval: {name} printed {len(lines)} metric lines: "
                                 f"{o[-2000:]}")
        outs[name] = lines[0]
    ref = outs["evaluate"]["metrics"]
    got = outs["distributed_evaluate"]["metrics"]
    rels = {f"{g}/{k}": abs(got[g][k] - ref[g][k]) / max(abs(ref[g][k]), 1e-12)
            for g, k in (("depth", "rel"), ("disp", "epe"))}
    print(f"dp2 eval: distributed_evaluate ({outs['distributed_evaluate']['mesh']}) against one "
          f"process in {time.perf_counter() - t0:.1f}s: {rels} (tol {EVAL_METRIC_REL_TOL:.3e}); "
          f"DP2 {got}; one process {ref}", flush=True)
    if not all(r <= EVAL_METRIC_REL_TOL for r in rels.values()):
        raise AssertionError(f"dp2 eval: DP2 metrics {rels} over {EVAL_METRIC_REL_TOL}")
    return dict(rel=rels, dp2=got, one_process=ref, wall_s=time.perf_counter() - t0,
                evaluate_line=outs["evaluate"])


def tp_phase(dp2: bool = True):
    """Tensor parallelism on the card, hermetic, in a temporary directory:

    - `torchrun --nproc-per-node 2 chip_smoke.py --tp-rank`: two ranks on
      the one card, gloo (NCCL refuses two ranks on one device). Each rank
      (1) runs `mha_attention_tp` (3600 x H5 and 920 x H10 at D64, bf16 and
      int8; the VAE's 3600 x H1 x D512, int8) and `geglu_ff_tp`
      (3600/320/1280, 920/640/2560, 240/1280/5120, 60/1280/5120, bf16 and
      static int8) at batch 1 against their plain compositions, timed (the
      composition, its kernel, its collective, the plain composition, the
      library call on the rank's share); (2) builds the full-width rgb+raw
      pipeline (`_tp_pipeline`, the same seeded weights on both ranks) and
      serves `D3RoMa` at batch 1, 360x640, TP_STEPS (1) DDIM steps under
      task.tensor_parallel=2, latency and throughput (calibrated on the
      meshed pipeline): the launch counts of one call (20 attention and
      32 GEGLU, each through its composition; 22 int8 attention and 32
      int8 GEGLU), the depth the same on both ranks, within the serve
      phase's tolerances of the tp=1 call on rank 0 (the same weights,
      inputs and noise; bf16 5e-2 of the disparity's max, int8 twice the
      int8 noise) and of the call through the plain compositions, ms/request
      (the mode's first call, which also builds its weight caches), its
      collectives' count, bytes and host ms, and the parameter bytes a rank
      holds;
    - (3) with `dp2`, the pipeline saved and `dp2_eval` on 4 procedural HISS
      frames (the whole pass runs it in the eval phase, on that phase's
      pipeline, frames and one-process line).

    Two ranks share one card: the times show correctness and the cost of
    passing through the host, not tensor parallelism's latency on two
    cards. Returns a summary dict."""
    import socket
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"max_sm_clock_mhz": _CARD["max_sm_clock_mhz"]}, f)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(TP_RANKS),
             "--master-addr", "localhost", "--master-port", str(port),
             os.path.abspath(__file__), "--tp-rank", spec],
            cwd=tmp, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", "")))
        for ln in proc.stdout.splitlines():
            print(f"  {ln}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-20000:], flush=True)
            raise AssertionError(f"tp: the ranks exited {proc.returncode}")
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"tp: {TP_RANKS} ranks in {time.perf_counter() - t0:.1f}s", flush=True)
        if not dp2:
            return dict(ranks=ranks)
        import torch

        from d3roma_tpu_torch.config import compose
        from d3roma_tpu_torch.synthetic import generate_dataset

        pipe_dir = os.path.join(tmp, "pipe")
        _tp_pipeline(compose([f"task={SERVE_PRESET}"]).task, "cuda").save_pretrained(pipe_dir)
        torch.cuda.empty_cache()
        generate_dataset(os.path.join(tmp, "datasets", "HISS"), EVAL_FRAMES, split="test")
        dp2 = dp2_eval(tmp, repo, pipe_dir)
        dp2.pop("evaluate_line")
        return dict(ranks=ranks, eval=dp2)


def _group(kernel_name: str) -> str:
    low = kernel_name.lower()
    for group, keys in _KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise and other"


def profile_phase(run, label: str = "pipeline", frames: int = BATCH):
    """One more pipeline call under torch.profiler: device time by kernel
    group and the device's idle share of the call's wall time (`frames`
    frames a call). Returns (wall ms, device busy ms)."""
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
          f"= {busy / frames:.1f} ms/frame, idle share {max(0.0, 1 - busy / wall_ms):.3f}",
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


PHASE_SECONDS: dict = {}


def _phase(fn, *args):
    """fn(*args), its wall seconds kept in PHASE_SECONDS under fn's name and
    printed, so that a log shows where the full pass spends its limit."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[fn.__name__] = round(time.perf_counter() - t0, 1)
    print(f"{fn.__name__}: {PHASE_SECONDS[fn.__name__]} s", flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of tp_phase, under torchrun
        return tp_rank_main(sys.argv[2])
    if sys.argv[1:2] == ["--mono-train"]:  # the mono phase's train entry point
        return mono_train_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--synthetic-train"]:  # the synthetic phase's entry points
        return synthetic_train_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--synthetic-eval"]:
        return synthetic_eval_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] in (["--train-parallel-rank"], ["--train-parallel-rank-gathered-ff"]):
        if sys.argv[1] == "--train-parallel-rank-gathered-ff":  # train_tp_ff_phase's control
            from d3roma_tpu_torch.models.layers import FeedForward

            FeedForward._paired_shards = lambda self: False
        # one rank of a multi-rank train run
        return train_parallel_child(sys.argv[2], int(sys.argv[3]) or None, sys.argv[4:])
    if sys.argv[1:2] == ["--train-first-epoch"]:  # the one-process run, its step 1 kept
        return first_epoch_child(sys.argv[2], sys.argv[3], sys.argv[4:])
    pin_one_card()
    card = device_phase()
    build_phase()
    if sys.argv[1:] == ["--tp"]:
        print(json.dumps({"tp": tp_phase()}), flush=True)
        print(card, flush=True)
        print("tp phase passed", flush=True)
        return 0
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
    if sys.argv[1:] == ["--eval"]:
        print(json.dumps({"eval": eval_phase()}), flush=True)
        print(card, flush=True)
        print("eval phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--train"]:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"train": train_phase(tmp)}), flush=True)
        print(card, flush=True)
        print("train phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--train-tp-ff"]:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"train_tp_ff": train_tp_ff_phase(tmp)}), flush=True)
        print(card, flush=True)
        print("train tp feed-forward phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--train-parallel"]:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"train_parallel": train_parallel_phase(tmp)}), flush=True)
        print(card, flush=True)
        print("train parallel phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--accuracy"]:
        print(json.dumps({"accuracy": accuracy_phase()}), flush=True)
        print(card, flush=True)
        print("accuracy phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--serve"]:
        print(json.dumps({"serve": serve_phase()}), flush=True)
        print(card, flush=True)
        print("serve phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--mono"]:
        print(json.dumps({"mono": mono_phase()}), flush=True)
        print(card, flush=True)
        print("mono phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--synthetic"]:
        print(json.dumps({"synthetic": synthetic_phase()}), flush=True)
        print(card, flush=True)
        print("synthetic phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--offline"]:
        print(json.dumps({"offline": offline_phase(card)}), flush=True)
        print(card, flush=True)
        print("offline phase passed", flush=True)
        return 0
    if sys.argv[1:] == ["--import"]:
        print(json.dumps({"import": import_phase()}), flush=True)
        print(card, flush=True)
        print("import phase passed", flush=True)
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
    attn_rows, geglu_rows = _phase(kernel_phase)
    int8_rows = _phase(int8_kernel_phase)
    opt_rows = _phase(opt_in_kernel_phase)
    new_rows = _phase(conv_and_fused_bf16_kernel_phase)
    pipe, inputs, counts, ms_per_frame = _phase(pipeline_phase)
    fused_counts, fused_ms_per_frame = _phase(latency_fused_phase, pipe, inputs)
    bench_counts, bench_ms_per_frame, bench_expected, visits = _phase(
        bench_default_phase, pipe, inputs)
    routes = _phase(conv_routes_phase, pipe, inputs, bench_expected)
    dynamic = _phase(dynamic_paths_phase, pipe, inputs, visits)
    vae8_counts, vae8_ms_per_frame = _phase(vae8_phase, pipe, inputs)
    opt_counts, opt_ms_per_frame = _phase(opt_in_phase, pipe, inputs)

    import tempfile

    import torch

    del pipe, inputs
    torch.cuda.empty_cache()
    pixel = _phase(pixel_phase)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as train_tmp:
        # the train frames, then the multi-rank train runs (TP2, then DP2)
        # beside the eval, train and accuracy phases
        multi = _phase(train_parallel_start, train_tmp)
        try:
            evaluation = _phase(eval_phase)  # its entry point's process builds its own models
            # so do its entry point's two one-process runs
            training = _phase(train_phase, train_tmp, multi)
            # on the bf16 checkpoint they wrote; its timed step below
            accuracy = _phase(accuracy_phase, train_tmp, False)
        finally:
            parallel = _phase(train_parallel_join, multi)
        training["parallel"] = parallel
        # the timed full-width steps, alone on the card
        training["timing"], accuracy["bf16_step"] = _phase(train_timings)
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as syn_tmp:
        prepared = []  # the synthetic frames and their sim depth, beside mono's processes
        mono = _phase(mono_phase, lambda: prepared.append(_Beside(_syn_prepare, syn_tmp, repo)))
        synthetic = _phase(synthetic_phase, syn_tmp, prepared[0])  # train, eval, camera
    serving = _phase(serve_phase)  # the demo, probe, calibration and server processes too
    torch.cuda.empty_cache()
    offline = _phase(offline_phase, card, serving["calibrate"])  # and the stereo CLI's
    torch.cuda.empty_cache()
    imported = _phase(import_phase)  # and the importer's and parity_check's
    tensor_parallel = _phase(tp_phase, False)  # and its two ranks' (DP2: the eval phase)
    bench_lines = _phase(bench_phase)
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}", flush=True)
    import_bf16 = imported["launches_latency_guided"]
    tp_rank0 = tensor_parallel["ranks"][0]
    import_int8 = imported["launches_throughput_guided"]

    def accuracy_int8(name):
        """A call's launches of `name` in each int8 row of the accuracy sweep."""
        return {f"int8:{k}": v.get(name, 0) for k, v in accuracy["launches"].items()}

    kernels = [
        dict(_kernel_entry("mha_attention", "d3roma_tpu_torch/csrc/attention.cu",
                           "d3roma_tpu/ops/pallas/attention.py:69", attn_rows,
                           counts["attention"]),
             eval_launches=evaluation["launches"]["attention"],
             serve_launches=serving["launches_latency"]["attention"],
             import_launches=import_bf16["attention"]),
        dict(_kernel_entry("geglu_ff", "d3roma_tpu_torch/csrc/geglu.cu",
                           "d3roma_tpu/ops/pallas/geglu.py:114", geglu_rows, counts["geglu"]),
             eval_launches=evaluation["launches"]["geglu"],
             serve_launches=serving["launches_latency"]["geglu"],
             import_launches=import_bf16["geglu"]),
        dict(_kernel_entry("mha_attention_int8", "d3roma_tpu_torch/csrc/attention_int8.cu",
                           "d3roma_tpu/ops/pallas/attention.py:90", int8_rows["attention_int8"],
                           bench_counts["attention_int8"]),
             serve_launches=serving["launches_throughput"]["attention_int8"],
             import_launches=import_int8["attention_int8"],
             accuracy_launches=accuracy_int8("attention_int8")),
        dict(_kernel_entry("geglu_ff_int8", "d3roma_tpu_torch/csrc/geglu_int8.cu",
                           "d3roma_tpu/ops/pallas/geglu.py:71", int8_rows["geglu_int8"],
                           bench_counts["geglu_int8"]),
             serve_launches=serving["launches_throughput"]["geglu_int8"],
             import_launches=import_int8["geglu_int8"],
             accuracy_launches=accuracy_int8("geglu_int8")),
        dict(_kernel_entry("conv2d_int8", "d3roma_tpu_torch/csrc/conv2d_int8.cu",
                           "d3roma_tpu/ops/pallas/conv2d.py:80", int8_rows["conv2d_int8"],
                           bench_counts["conv2d_int8"]),
             tma_map_host_cost=new_rows["tma_map_host_cost"],
             serve_launches=serving["launches_throughput"]["conv2d_int8"],
             import_launches=import_int8["conv2d_int8"],
             accuracy_launches=accuracy_int8("conv2d_int8")),
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
        dict(_kernel_entry("quantize_int8", "d3roma_tpu_torch/csrc/quantize.cu",
                           "d3roma_tpu/ops/quant.py:64", int8_rows["quantize"],
                           bench_counts["quantize"]),
             import_launches=import_int8["quantize"],
             accuracy_launches=accuracy_int8("quantize")),
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
        # the tensor-parallel compositions of rows 1/1b and 2/2b: rank 0's
        # numbers (two ranks on the one card); launches a latency call
        _kernel_entry("mha_attention_tp", "d3roma_tpu_torch/ops/kernels/attention.py",
                      "d3roma_tpu/ops/pallas/attention.py:220", tp_rank0["attention"],
                      tp_rank0["latency"]["launches"]["attention_tp"],
                      f"a rank's latency call at tensor_parallel=2; "
                      f"{tp_rank0['throughput']['launches']['attention_tp']} a throughput call"),
        _kernel_entry("geglu_ff_tp", "d3roma_tpu_torch/ops/kernels/geglu.py",
                      "d3roma_tpu/ops/pallas/geglu.py:267", tp_rank0["geglu"],
                      tp_rank0["latency"]["launches"]["geglu_tp"],
                      f"a rank's latency call at tensor_parallel=2; "
                      f"{tp_rank0['throughput']['launches']['geglu_tp']} a throughput call"),
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
    print(json.dumps({"eval": evaluation}), flush=True)
    print(json.dumps({"train": training}), flush=True)
    print(json.dumps({"accuracy": accuracy}), flush=True)
    print(json.dumps({"mono": mono}), flush=True)
    print(json.dumps({"synthetic": synthetic}), flush=True)
    print(json.dumps({"serve": serving}), flush=True)
    print(json.dumps({"offline": offline}), flush=True)
    print(json.dumps({"import": imported}), flush=True)
    print(json.dumps({"tp": tensor_parallel}), flush=True)
    print(json.dumps({"torch_bench": bench_lines}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
