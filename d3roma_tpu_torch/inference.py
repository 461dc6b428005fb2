"""Single-frame and batched inference API, the deployment surface of the port.

Port of `d3roma_tpu/inference.py` (reference: inference.py:37-250): composes
a config from overrides, loads a pipeline directory (either package's
format), optionally swaps the sampler to MyDDIM, applies
`task.fast_inference` and `task.deepcache`, and exposes
``infer(left, right, raw_depth, rgb)``, ``infer_with_rgb_raw(rgb,
raw_depth)`` and ``infer_with_rgb_raw_batch(frames)``, which return metric
depth in meters.

A call has three parts. The host prep resizes the frames to the camera
resolution with OpenCV's semantics (`utils/resize.py`) and turns depth into
raw disparity, in numpy. `_upload` copies the arrays to the device. Then
normalize, the rounds as a batch, the pipeline, denormalize, the std over
the rounds, the mean and disparity -> depth run on the device with no host
synchronization, and `_fetch` copies the depth (and the uncertainty, and the
single-frame path's metrics for its log line) back.

The pipeline's images [N*R, H, W, C] are denormalized as the JAX
`post_fn` does: each frame's C images (C = 1 for the latent family) with
their R rounds stacked last, all N*C in one call, the logged metrics over
all of them; the depth and the uncertainty returned are image 0's.

With the latent family's guidance enabled (`flow_guidance_weight > 0`,
gradient mode), the pipeline takes the raw disparity, the config's
denormalization as `denorm_builder` and the sensor mask, as the JAX
`run_pipeline` does.

Noise: one `torch.Generator` on the device, seeded with the config's seed
(else `seed`), that every call draws from in call order: the pipeline's
latents and step noise, then the SSI RANSAC subsets under `safe_ssi`. (The
JAX package splits a PRNG key a call and folds in 1 for the RANSAC; a
torch generator draws other noise.) The guidance's denormalization seeds
its own RANSAC generator with 0 at each call, as the JAX one takes
PRNGKey(0).

Tensor parallelism (`task.tensor_parallel=T`): run under `torchrun
--nproc-per-node N` (T divides N), every rank making the same calls. Each
rank joins the process group (`parallel/mesh.py::init_distributed`: NCCL
when each rank has a card, gloo when ranks share one), and the pipeline,
loaded or passed, is sharded over a (N / T, T) mesh
(`parallel/tensor.py::shard_pipeline_tp`). The inputs, the noise (each
rank's generator has the same seed) and the outputs are replicated; every
rank returns the depth. Calibrate static int8 after the sharding (the
kernel gates under the mesh decide the scale call order).

Not ported, and refused: the executable cache (`task.aot_cache`,
`serving/aot.py`): ROADMAP.md §1 item 10.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from d3roma_tpu_torch.config import TrainingConfig, compose, deepcache_active
from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.evaluation.eval_loop import denormalize
from d3roma_tpu_torch.ops.metrics import compute_errors, metrics_to_dict
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.parallel import init_distributed, shard_pipeline_tp
from d3roma_tpu_torch.pipelines import (
    GuidedDiffusionPipeline,
    GuidedLatentDiffusionPipeline,
    SamplerSpec,
)
from d3roma_tpu_torch.utils.camera import Realsense
from d3roma_tpu_torch.utils.resize import INTER_LINEAR, INTER_NEAREST, resize

logger = logging.getLogger(__name__)


def _three_channels(x: np.ndarray) -> np.ndarray:
    if x.ndim == 2:
        x = np.tile(x[..., None], (1, 1, 3))
    return x[..., :3]


class D3RoMa:
    """Depth restoration from stereo IR / RGB-D frames, on `device` (CUDA
    unless the caller names another; without CUDA it raises)."""

    RELEASED_VARIANTS = ("left+right+raw", "rgb+raw")

    def __init__(self, overrides: List[str] = (), camera: Optional[Realsense] = None,
                 variant: str = "left+right+raw", pipeline=None, seed: int = 0,
                 device: DeviceLike = None):
        assert variant in self.RELEASED_VARIANTS, "not released yet"
        base_cfg = compose(overrides)
        config = base_cfg.task
        if base_cfg.seed is not None and base_cfg.seed != -1:
            seed = base_cfg.seed
        tp = max(1, int(getattr(config, "tensor_parallel", 1) or 1))
        self.device = resolve_device(device) if tp == 1 else init_distributed(device)
        if tp > 1:
            world = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
            if world % tp or world == 1:
                raise RuntimeError(
                    f"task.tensor_parallel={tp} needs a process group whose world size it "
                    f"divides (this process has a world of {world}): launch with "
                    f"torchrun --nproc-per-node {tp} ...")
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

        if getattr(config, "aot_cache", ""):
            raise NotImplementedError(
                "task.aot_cache needs serving/aot.py, not ported yet (ROADMAP.md §1 item 10)")

        self.camera = camera
        self.camera.change_resolution(f"{config.image_size[1]}x{config.image_size[0]}")
        self.config = config
        self.pipeline = pipeline if pipeline is not None else self._load_pipeline(config)
        self.mesh = None
        if tp > 1:
            # applied here, not in _load_pipeline, so that a pipeline passed
            # in is sharded too
            self.pipeline, self.mesh = shard_pipeline_tp(self.pipeline, tp, logger)
        self.eval_output_dir = f"_outputs.{variant}"
        os.makedirs(self.eval_output_dir, exist_ok=True)
        self.normer = Normalizer.from_config(config)
        self.variant = variant
        self.last_uncertainty = None
        # the guidance's denormalizer: the config's, RANSAC seeded 0 a call
        self._denorm_builder = lambda x, raw, mask: denormalize(self.config, x, raw, mask)

    def _load_pipeline(self, config: TrainingConfig):
        path = f"{config.resume_pretrained}"
        if not os.path.exists(path):
            raise ValueError(f"pretrained path not exists: {path}")
        logger.info("load weights from %s", path)
        cls = GuidedLatentDiffusionPipeline if config.ldm else GuidedDiffusionPipeline
        pipeline = cls.from_pretrained(path, device=self.device)
        if pipeline.guidance is not None:
            pipeline.guidance = dataclasses.replace(
                pipeline.guidance, flow_guidance_mode=config.flow_guidance_mode)
        if config.sampler == "my_ddim":
            # sampler override (reference: inference.py:77-92)
            pipeline = pipeline.replace_sampler(
                SamplerSpec("my_ddim", config.schedule_config(train=False)))
            logger.info("Careful! sampler is overriden to %s", config.sampler)
        if config.fast_inference != "off" and hasattr(pipeline, "fast_inference"):
            pipeline = pipeline.fast_inference(config.fast_inference)
            logger.info("fast_inference=%s kernels enabled", config.fast_inference)
        if ((deepcache_active(config.deepcache) or config.deepcache_depth != 1)
                and hasattr(pipeline, "deepcache")):
            pipeline = pipeline.deepcache(config.deepcache, depth=config.deepcache_depth)
            logger.info("deepcache schedule=%s depth=%d enabled", config.deepcache,
                        config.deepcache_depth)
        return pipeline

    # ------------------------------------------------------------------ #
    # host prep
    def _size(self):
        return self.camera.resolution[::-1]  # (width, height), as cv2 takes it

    def _raw_disparity(self, raw_depth: np.ndarray) -> np.ndarray:
        if raw_depth.shape[:2] != tuple(self.camera.resolution):
            raw_depth = resize(raw_depth, self._size(), interpolation=INTER_NEAREST)
        return np.where(raw_depth > 0,
                        self.camera.fxb_depth / np.maximum(raw_depth, 1e-8), 0.0)

    def _prep_rgb_raw(self, rgb: np.ndarray, raw_depth: np.ndarray):
        """Resize to the camera resolution, depth (m) -> raw disparity
        (reference: inference.py:98-134)."""
        assert rgb.dtype == np.uint8
        rgb = resize(_three_channels(rgb), self._size(), interpolation=INTER_LINEAR)
        assert self.config.prediction_space == "disp", "not implemented"
        return rgb, self._raw_disparity(raw_depth).astype(np.float32)

    def infer_with_rgb_raw(self, rgb: np.ndarray, raw_depth: np.ndarray) -> np.ndarray:
        """RGB (uint8, aligned with depth) + raw depth (meters) -> restored
        metric depth [H,W] float32 (reference: inference.py:98-134)."""
        rgb, raw_disp = self._prep_rgb_raw(rgb, raw_depth)
        return self.run_pipeline(None, None, raw_disp, rgb)

    def infer_with_rgb_raw_batch(self, frames) -> List[np.ndarray]:
        """N (rgb uint8 [H,W,3] or [H,W], raw_depth float meters [H,W])
        frames in one pipeline call at batch N x rounds; a list of [H,W]
        float32 metric depths in frame order. `streaming.MicroBatcher`
        aggregates concurrent requests into it."""
        rgbs, disps = [], []
        for rgb, raw_depth in frames:
            rgb, raw_disp = self._prep_rgb_raw(rgb, raw_depth)
            rgbs.append(rgb)
            disps.append(raw_disp)
        depths = self.run_pipeline_batch(np.stack(disps), np.stack(rgbs))
        return [depths[i] for i in range(len(frames))]

    def infer(self, left: np.ndarray, right: np.ndarray,
              raw_depth: Optional[np.ndarray] = None,
              rgb: Optional[np.ndarray] = None) -> np.ndarray:
        """Stereo IR pair (+ raw depth, + rgb) -> restored metric depth
        (reference: inference.py:136-190)."""
        def prep_gray(x):
            return resize(_three_channels(x), self._size(), interpolation=INTER_LINEAR)

        left = prep_gray(left)
        right = prep_gray(right)
        if rgb is not None:
            rgb = prep_gray(rgb)
        if raw_depth is not None:
            raw_disp = self._raw_disparity(raw_depth)
        else:
            raw_disp = np.zeros(self.camera.resolution, np.float32)
        assert left.shape[0] % 8 == 0 and left.shape[1] % 8 == 0, (
            "image size must be multiple of 8")
        return self.run_pipeline(left, right, raw_disp.astype(np.float32), rgb)

    # ------------------------------------------------------------------ #
    # device
    def _upload(self, **arrays):
        """numpy -> tensors on the device (None stays None)."""
        return {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in arrays.items()}

    def _const(self, value: float) -> torch.Tensor:
        # a 0-d fill on the device, not a copy from the host; dividing by a
        # tensor is IEEE division on every device (CUDA multiplies by the
        # reciprocal of a Python scalar divisor)
        return torch.full((), value, dtype=torch.float32, device=self.device)

    def _norm_rgb(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return (x.to(torch.float32) / self._const(255.0) - 0.5) * 2.0

    def _to_depth(self, disp: torch.Tensor) -> torch.Tensor:
        fxb = self._const(self.camera.fxb_depth)
        return torch.where(disp > 0, fxb / torch.clamp(disp, min=1e-8), torch.zeros_like(disp))

    def _pipeline_kwargs(self, raw_b, mask_b):
        """The config's part of a pipeline call: the raw disparity [B,H,W,1]
        and its mask go to the guidance (latent) or the imputation mask
        (pixel)."""
        kwargs = dict(num_inference_steps=self.config.num_inference_timesteps,
                      cond_channels=self.config.cond_channels,
                      add_noise_rgb=self.config.noise_rgb, generator=self._generator)
        if hasattr(self.pipeline, "vae"):  # the latent pipeline
            if self.config.split_programs:
                kwargs["split_programs"] = True
            if self.config.scan_chunk:
                kwargs["scan_chunk"] = self.config.scan_chunk
            if self.pipeline.guidance is not None and self.pipeline.guidance.enabled:
                kwargs.update(raw_depth=raw_b, denorm_builder=self._denorm_builder,
                              denorm_mask=mask_b)
        else:
            kwargs["depth_channels"] = self.config.depth_channels
            # the sensor-validity mask for imputation guidance: the
            # pipeline's fallback (sim_disp != 0) is wrong for a non-SSI
            # normalizer (raw 0 normalizes to -1)
            kwargs["raw_mask"] = mask_b
        return kwargs

    def _device(self, raw_disp, rgb=None, left=None, right=None, metrics=False):
        """N frames, raw disparity [N,H,W] and images [N,H,W,3] uint8 (or
        None), in one pipeline call at batch N*R, frame-major (a frame's
        rounds adjacent): (depth [N,H,W], uncertainty [N,H,W]) of each
        frame's image 0, and with `metrics` (metrics_disp, metrics_depth)
        of all its C images against the raw disparity."""
        R = self.config.num_inference_rounds
        N = raw_disp.shape[0]

        def rep(x):
            if x is None:
                return None
            return x[:, None].expand((N, R) + tuple(x.shape[1:])).reshape(
                (N * R,) + tuple(x.shape[1:]))

        raw = raw_disp[..., None]  # [N,H,W,1]
        normalized, _, _ = self.normer.normalize(raw)  # per sample
        raw_b = rep(raw)
        mask_b = (raw_b > 0).to(torch.float32)
        kwargs = self._pipeline_kwargs(raw_b, mask_b)
        out = self.pipeline(num_intermediate_images=self.config.num_intermediate_images,
                            rgb_images=rep(self._norm_rgb(rgb)),
                            left_images=rep(self._norm_rgb(left)),
                            right_images=rep(self._norm_rgb(right)),
                            sim_disp=rep(normalized), **kwargs)
        # rounds-as-batch [N*R,H,W,C] -> [N*C,H,W,R] (frame-major): the SSI
        # alignment over the rounds of each of a frame's C images
        pred = out.images.to(torch.float32)
        C, (Hp, Wp) = pred.shape[-1], pred.shape[1:3]
        p = pred.reshape(N, R, Hp, Wp, C).permute(0, 4, 2, 3, 1).reshape(N * C, Hp, Wp, R)
        raw_c = raw.repeat_interleave(C, dim=0)
        unnorm = denormalize(self.config, p, raw_c, (raw_c > 0).to(torch.float32),
                             generator=self._generator)
        unc = torch.std(p, dim=-1, correction=0).reshape(N, C, Hp, Wp)[:, 0]
        mean = torch.mean(unnorm, dim=-1)  # [N*C,H,W]
        depth = self._to_depth(mean.reshape(N, C, Hp, Wp)[:, 0])
        if not metrics:
            return depth, unc
        disp_c = raw_disp.repeat_interleave(C, dim=0)
        fxb = self._const(self.camera.fxb_depth).expand(N * C)
        return depth, unc, compute_errors(
            disp_c, mean, self.config.prediction_space, disp_c > 0, fxb)

    def _fetch(self, depth, unc, metrics=None) -> np.ndarray:
        """The device -> host copies at the end of a call."""
        if self.config.num_inference_rounds > 1:
            self.last_uncertainty = unc.cpu().numpy()
        if metrics is not None:
            logger.info("metrics vs raw: %s", metrics_to_dict(*metrics))
        return depth.to(torch.float32).cpu().numpy()

    def run_pipeline(self, left_image, right_image, raw_disp, rgb) -> np.ndarray:
        """Normalize, batch by inference rounds, denoise, denormalize,
        convert to metric depth (reference: inference.py:191-250)."""
        def one(x):
            return None if x is None else x[None]

        up = self._upload(raw_disp=one(raw_disp), rgb=one(rgb), left=one(left_image),
                          right=one(right_image))
        depth, unc, metrics = self._device(**up, metrics=True)
        return self._fetch(depth[0], unc[0], metrics)

    def run_pipeline_batch(self, raw_disps: np.ndarray, rgbs: np.ndarray) -> np.ndarray:
        """The batched `run_pipeline` of the rgb+raw variant: N frames in one
        pipeline call at batch N*rounds; [N,H,W] metric depth. The serving
        contract decodes only the final prediction, so the config must set
        num_intermediate_images=1 (the reference's deployment override,
        d3roma_processor.py:38-42)."""
        assert self.config.num_intermediate_images == 1, (
            "batched serving decodes only the final prediction")
        return self._fetch(*self._device(**self._upload(raw_disp=raw_disps, rgb=rgbs)))
