"""The training loop.

Port of `d3roma_tpu/training/train_loop.py`, on one device: model
construction per family, the train step, the loss-aware sampler, periodic
in-training evaluation over every val loader with the `best/` export on a
better EPE, per-epoch `checkpoints/last` and `epoch_NNNN/` exports, resume
with the mid-epoch fast-forward, scalar logging and abnormal-loss
forensics.

Randomness: step i's draws come from a generator seeded with a pure
function of (seed, i) (`step_draws`), so a resumed run draws what an
uninterrupted one would; the in-training eval of step i draws from
(seed, 1_000_000 + i, loader index). A test replaces `step_draws` to
replay the JAX package's draws.

The metrics of a step are read back one step late, after the next step
is enqueued, as the JAX loop drains them: the host waits for step i while
the device already has step i + 1. On CUDA the fp32 path computes in full
fp32: TF32 is off for matmuls and cuDNN convolutions while `train` runs
(PyTorch's cuDNN default rounds fp32 convolutions to TF32), and restored
after.

`mixed_precision="bf16"` (and "fp16", which means the same, as in the
JAX package: no loss scaler) computes the freshly built models in bf16
over fp32 parameters (`models.set_compute_dtype`): the parameters, the
optimizer state, `checkpoints/last/state.pt` and every export stay fp32;
the loss, its reductions and the fp32-pinned sites (the UNet's and the
VAE's `conv_out`, the VAE's quant convs) stay fp32, as the JAX trainer's
`build_models(dtype=bfloat16)` has them. The frozen VAE computes in bf16
too. Models loaded from `task.resume_pretrained` compute as loaded, as in
the JAX package, whose pipeline directories build their modules in fp32.

Not ported, and refused with NotImplementedError: `tensor_parallel > 1`
and multi-card training (ROADMAP.md section 1, item 10).
"""

from __future__ import annotations

import contextlib
import logging
import os
from functools import partial
from typing import Optional

import numpy as np
import torch

from d3roma_tpu_torch.data import device_preprocess, fetch_dataloader, preprocess_eval
from d3roma_tpu_torch.data.prefetch import device_prefetch, to_device
from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.evaluation.eval_loop import evaluate_dataset
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2D,
    UNet2DCondition,
    init_random_,
    pixel_in_channels,
    set_compute_dtype,
    widened_in_channels,
)
from d3roma_tpu_torch.ops.noise import GeneratorDraws
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.padding import InputPadder
from d3roma_tpu_torch.pipelines import (
    GuidedDiffusionPipeline,
    GuidedLatentDiffusionPipeline,
    create_sampler_spec,
)
from d3roma_tpu_torch.training.checkpoint import latest_checkpoint, load_state, save_state
from d3roma_tpu_torch.training.forensics import AbnormalLossDetector
from d3roma_tpu_torch.training.state import StepCounter, build_optimizer, create_train_state
from d3roma_tpu_torch.training.train_step import make_train_step

logger = logging.getLogger(__name__)

EVAL_SEED_OFFSET = 1_000_000


def _derived_seed(*words: int) -> int:
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])


def step_draws(seed: int, step: int, device: torch.device) -> GeneratorDraws:
    """The draws of global step `step`: a generator on `device` seeded with
    a pure function of (seed, step)."""
    return GeneratorDraws(torch.Generator(device=device).manual_seed(_derived_seed(seed, step)))


def eval_generator(seed: int, step: int, loader_index: int) -> torch.Generator:
    """The generator the in-training eval of step `step` draws its batch
    seeds from, for val loader `loader_index`."""
    return torch.Generator().manual_seed(
        _derived_seed(seed, EVAL_SEED_OFFSET + step, loader_index))


@contextlib.contextmanager
def fp32_math(device: torch.device):
    """Full-fp32 matmuls and cuDNN convolutions on CUDA, restored on exit."""
    if device.type != "cuda":
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _check_supported(config) -> None:
    if int(getattr(config, "tensor_parallel", 1) or 1) > 1:
        raise NotImplementedError(
            "tensor_parallel > 1: multi-card training is not ported yet "
            "(ROADMAP.md section 1, item 10)")


def build_models(config, seed: int = 0, device: DeviceLike = None) -> dict:
    """The model family on `device`: unet (+ vae, text_embed for the
    latent family). From `config.resume_pretrained` (a pipeline directory
    of either package) when set, computing as loaded; else random fp32
    weights drawn from a generator seeded with `seed`, computing in bf16
    under mixed precision "bf16" or "fp16" (the JAX package maps both to
    bf16 compute over the fp32 parameters), else in fp32. The latent UNet
    rematerializes its blocks in training (remat=True, as the JAX trainer
    builds it); the VAE is frozen."""
    _check_supported(config)
    device = resolve_device(device)
    models = _build_models(config, seed, device)
    if not config.resume_pretrained and config.mixed_precision in ("bf16", "fp16"):
        for name in ("unet", "vae"):
            if name in models:
                set_compute_dtype(models[name], torch.bfloat16)
    return models


def _build_models(config, seed: int, device: torch.device) -> dict:
    if config.ldm:
        assert config.depth_channels == 4, "ldm only support 4 channels"
        if config.resume_pretrained:
            pipe = GuidedLatentDiffusionPipeline.from_pretrained(config.resume_pretrained,
                                                                 device=device)
            pipe.unet.remat = True
            return dict(unet=pipe.unet, vae=pipe.vae.requires_grad_(False),
                        text_embed=pipe.text_embed)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        unet = UNet2DCondition(in_channels=widened_in_channels(config.cond_channels),
                               out_channels=4, remat=True, device=device)
        init_random_(unet, gen)
        vae = AutoencoderKL(device=device)
        init_random_(vae, gen)
        # frozen empty-prompt embedding [1, 2, D] ([BOS, EOS]); imported
        # checkpoints replace it
        text_embed = torch.zeros((1, 2, unet.cross_attention_dim), device=device)
        return dict(unet=unet, vae=vae.requires_grad_(False), text_embed=text_embed)
    in_ch = pixel_in_channels(config.cond_channels, config.depth_channels)
    if config.resume_pretrained:
        pipe = GuidedDiffusionPipeline.from_pretrained(config.resume_pretrained, device=device)
        return dict(unet=pipe.unet)
    # attention on the second-deepest level (the deepest for fewer than
    # four levels), groups the largest count <= 32 dividing every width
    n_blocks = len(config.block_out_channels)
    attn_idx = n_blocks - 2 if n_blocks >= 4 else n_blocks - 1
    down_types = tuple("AttnDownBlock2D" if i == attn_idx else "DownBlock2D"
                       for i in range(n_blocks))
    up_types = tuple("AttnUpBlock2D" if i == (n_blocks - 1 - attn_idx) else "UpBlock2D"
                     for i in range(n_blocks))
    groups = next(g for g in range(min(32, min(config.block_out_channels)), 0, -1)
                  if all(c % g == 0 for c in config.block_out_channels))
    unet = UNet2D(in_channels=in_ch, out_channels=config.depth_channels,
                  block_out_channels=tuple(config.block_out_channels),
                  down_block_types=down_types, up_block_types=up_types,
                  norm_groups=groups, device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(int(seed)))
    return dict(unet=unet)


def create_pipeline(config, models: dict):
    """An export-ready pipeline over the live training models (their
    parameters are shared, not copied), on their device."""
    spec = create_sampler_spec(config, train=False)
    guidance = FlowGuidance(
        flow_guidance_weight=config.flow_guidance_weights[0],
        perturb_start_ratio=config.perturb_start_ratio,
        flow_guidance_mode=config.flow_guidance_mode,
    )
    normalizer = Normalizer.from_config(config)
    device = next(models["unet"].parameters()).device
    if config.ldm:
        return GuidedLatentDiffusionPipeline(
            unet=models["unet"], vae=models["vae"], text_embed=models["text_embed"],
            spec=spec, normalizer=normalizer, device=device, guidance=guidance)
    return GuidedDiffusionPipeline(unet=models["unet"], spec=spec, guidance=guidance,
                                   normalizer=normalizer, device=device)


def _preprocess_and_pad(raw_batch, config, normalizer, device):
    """A host batch on the device, preprocessed, padded to divis_by."""
    batch = device_preprocess(to_device(raw_batch, device), normalizer, config.prediction_space)
    padder = InputPadder(batch["normalized_disp"].shape, divis_by=config.divis_by)
    padded_keys = ("normalized_disp", "sim_disp", "normalized_rgb", "left_image", "right_image")
    out = dict(batch)
    out.update(zip(padded_keys, padder.pad(*[batch[k] for k in padded_keys])))
    (out["mask"],) = padder.pad_zero(batch["mask"])
    return out


def train(config, base_config=None, output_dir: Optional[str] = None,
          max_steps: Optional[int] = None, writer=None, device: DeviceLike = None):
    """Full training run on `device` (CUDA unless the caller names
    another). Returns (state, counter, models)."""
    _check_supported(config)
    device = resolve_device(device)
    with fp32_math(device):
        return _train(config, base_config, output_dir, max_steps, writer, device)


def _train(config, base_config, output_dir, max_steps, writer, device):
    output_dir = output_dir or config.output_dir or "experiments/run"
    os.makedirs(output_dir, exist_ok=True)
    seed = getattr(base_config, "seed", 0) if base_config is not None else 0
    if seed is None or seed < 0:
        seed = 0

    train_loader, val_loaders = fetch_dataloader(config, seed=seed)
    steps_per_epoch = max(1, len(train_loader))
    logger.info("train batches/epoch: %d", steps_per_epoch)

    models = build_models(config, seed, device)
    unet = models["unet"]
    n_params = sum(p.numel() for p in unet.parameters())
    logger.info("total trainable params: %.1fM", n_params / 1e6)

    tables = config.schedule_config(train=True).tables(device)
    normalizer = Normalizer.from_config(config)
    optimizer = build_optimizer(config, steps_per_epoch, list(unet.parameters()))
    state = create_train_state(config, unet, steps_per_epoch, seed, optimizer=optimizer)
    counter = StepCounter()

    resume_dir = config.resume_ckpt or latest_checkpoint(output_dir)
    if resume_dir:
        logger.info("resuming from %s", resume_dir)
        state, counter = load_state(resume_dir, state)

    step_fn = make_train_step(config, unet, optimizer, tables, models.get("vae"),
                              models.get("text_embed"))
    preprocess = partial(_preprocess_and_pad, config=config, normalizer=normalizer,
                         device=device)
    eval_preprocess = partial(preprocess_eval, config=config, normalizer=normalizer,
                              device=device)

    detector = AbnormalLossDetector(output_dir)
    done = False
    storm_saves = 0
    skip_batches = counter.local_step  # mid-epoch fast-forward
    start_epoch = counter.epoch
    # the most recently enqueued step's metrics, read one step late
    pending = None  # (metrics, raw_batch, dispatch_step)

    def drain():
        nonlocal pending, storm_saves
        if pending is None:
            return
        metrics, raw_batch, gstep = pending
        pending = None
        loss = float(metrics["loss"])
        grad_norm = float(metrics["grad_norm"])
        logger.info("step %d loss %.6g grad_norm %.6g", gstep + 1, loss, grad_norm)
        abnormal = detector.check(loss, counter.avg_loss, gstep, gstep, raw_batch, metrics,
                                  paths=raw_batch.get("path"))
        if abnormal and storm_saves < 2:
            # forensic snapshot, capped: the chain rejects non-finite
            # updates, so repeats add no information
            storm_saves += 1
            save_state(os.path.join(output_dir, "checkpoints", f"{gstep}_storm"), state, counter)
        counter.record(loss)
        if writer is not None and (gstep + 1) % 10 == 0:
            writer.add_scalar("train/loss", loss, gstep + 1)
            writer.add_scalar("train/grad_norm", grad_norm, gstep + 1)
            if "recon_mae" in metrics:
                writer.add_scalar("train/recon_mae", float(metrics["recon_mae"]), gstep + 1)

    for epoch in range(start_epoch, config.num_epochs):
        train_loader.set_epoch(epoch)
        # the fast-forward skips batches before they are prepared
        items = ((bi, rb) for bi, rb in enumerate(train_loader)
                 if not (epoch == start_epoch and bi < skip_batches))
        prefetched = device_prefetch(items, prepare=lambda item: (item[0], item[1],
                                                                  preprocess(item[1])))
        last_bi = steps_per_epoch - 1 if epoch == start_epoch and skip_batches else -1
        for bi, raw_batch, batch in prefetched:
            last_bi = bi
            dispatch_step = counter.global_step
            metrics = step_fn(state, batch, step_draws(seed, dispatch_step, device))
            counter.tick()  # advance at dispatch; the loss is recorded on drain
            drain()
            pending = (metrics, raw_batch, dispatch_step)

            if counter.global_step % config.val_every_global_steps == 0 and val_loaders:
                pipeline = create_pipeline(config, models)
                for vi, vl in enumerate(val_loaders):
                    m, _ = evaluate_dataset(
                        config, pipeline, vl, eval_generator(seed, counter.global_step, vi),
                        preprocess=eval_preprocess, max_batches=config.eval_num_batch,
                        dataset_name=(config.eval_dataset[vi]
                                      if vi < len(config.eval_dataset or []) else None))
                    if m:
                        logger.info("eval[%d] @%d: %s", vi, counter.global_step, m)
                        if writer is not None:
                            for k, v in m["disp"].items():
                                writer.add_scalar(f"val{vi}/disp_{k}", v, counter.global_step)
                        if vi == 0 and m["disp"]["epe"] < counter.best_epe:
                            counter.best_epe = m["disp"]["epe"]
                            pipeline.save_pretrained(os.path.join(output_dir, "best"))
                            logger.info("new best EPE %.4f -> exported best/", counter.best_epe)

            if max_steps is not None and counter.global_step >= max_steps:
                done = True
                break

        drain()  # the last step's loss lands before the checkpoint

        # a max_steps stop mid-epoch does not advance the epoch: the saved
        # local_step drives the resume fast-forward
        epoch_complete = (not done) or (last_bi == steps_per_epoch - 1)
        if epoch_complete:
            counter.new_epoch()
        save_state(os.path.join(output_dir, "checkpoints", "last"), state, counter)
        if epoch_complete and (epoch + 1) % config.save_model_epochs == 0:
            create_pipeline(config, models).save_pretrained(
                os.path.join(output_dir, f"epoch_{epoch:04d}"))
        if done:
            break

    return state, counter, models
