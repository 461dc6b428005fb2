"""The latent diffusion pipeline: UNet + VAE + the baked empty-prompt
embedding + sampler + normalizer.

Port of `d3roma_tpu/pipelines/pipeline.py::GuidedLatentDiffusionPipeline`:
`__call__`, `half_precision` and `fast_inference("latency")` (bf16 weights,
the whole-row attention kernel at self-attention sites of >= 512 tokens, the
fused GEGLU kernel). Guidance, DeepCache, static int8 and its calibration,
split programs / scan chunks and the compiled-program cache are not ported
yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.models.unet2d_condition import UNet2DCondition
from d3roma_tpu_torch.models.vae import AutoencoderKL, decode_latent, encode_image_to_latent
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.pipelines.sampling import (
    PipelineOutput,
    SamplerSpec,
    latent_decode_images,
    latent_denoise,
    latent_encode_conds,
)


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Flow guidance settings. Guidance is not ported yet, so only a
    disabled configuration is accepted."""

    enabled: bool = False


@dataclasses.dataclass
class GuidedLatentDiffusionPipeline:
    """The models are moved to `device` (CUDA unless the caller names
    another) when the pipeline is made."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    text_embed: torch.Tensor  # [1, T, cross_attention_dim]
    spec: SamplerSpec
    normalizer: Normalizer
    device: DeviceLike = None
    guidance: Optional[GuidanceConfig] = None

    def __post_init__(self):
        if self.guidance is not None and self.guidance.enabled:
            raise NotImplementedError("guidance is not ported yet")
        self.device = resolve_device(self.device)
        self.unet.to(self.device)
        self.vae.to(self.device)
        self.text_embed = torch.as_tensor(self.text_embed).to(self.device)
        self._tables = self.spec.schedule.tables(self.device)

    def half_precision(self) -> "GuidedLatentDiffusionPipeline":
        """Inference-only bf16 weights. Casts the UNet and the VAE in place
        (PyTorch's Module.to) and returns this pipeline."""
        self.unet.to(torch.bfloat16)
        self.vae.to(torch.bfloat16)
        return self

    def fast_inference(self, mode: str = "latency") -> "GuidedLatentDiffusionPipeline":
        """"latency": bf16 weights, the whole-row attention kernel at the
        self-attention sites of >= 512 tokens, the fused GEGLU kernel in
        every transformer block. "off" returns the pipeline unchanged. The
        int8 modes ("throughput", "dense", "wino") are not ported yet."""
        if mode in ("off", "", None):
            return self
        if mode in ("throughput", "dense", "wino"):
            raise NotImplementedError(f"fast_inference({mode!r}): int8 and Winograd "
                                      f"are not ported yet")
        if mode != "latency":
            raise ValueError(f"unknown fast_inference mode {mode!r}")
        pipe = self.half_precision()
        pipe.unet.set_kernels(use_flash_attention="pallas-self", fused_ff=True)
        return pipe

    def __call__(
        self,
        num_inference_steps: int,
        num_intermediate_images: int,
        cond_channels: str,
        rgb_images: Optional[torch.Tensor] = None,
        left_images: Optional[torch.Tensor] = None,
        right_images: Optional[torch.Tensor] = None,
        sim_disp: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        raw_depth=None,
        denormer=None,
        denorm_builder=None,
        add_noise_rgb: bool = False,
        split_programs: bool = False,
        scan_chunk: Optional[int] = None,
    ) -> PipelineOutput:
        """Restore disparity from the conditions (NHWC, in [-1, 1]): encode
        them once, run the sampler from `latents` (or noise drawn from
        `generator`) and decode. Returns the decoded final x_hat0 in
        [-1, 1]; `self.normalizer.denormalize` turns it into disparity."""
        if raw_depth is not None or denormer is not None or denorm_builder is not None:
            raise NotImplementedError("guidance (raw_depth / denormer) is not ported yet")
        if add_noise_rgb:
            raise NotImplementedError("add_noise_rgb is not ported yet")
        if split_programs or scan_chunk:
            raise NotImplementedError("split_programs / scan_chunk are not ported")

        def on_device(x):
            return None if x is None else torch.as_tensor(x).to(self.device)

        rgb, left, right, raw = map(on_device, (rgb_images, left_images, right_images,
                                                sim_disp))
        ref = next(x for x in (rgb, left, right, raw) if x is not None)
        with torch.no_grad():
            conds, lat = latent_encode_conds(
                lambda x: encode_image_to_latent(self.vae, x), cond_channels,
                rgb=rgb, left=left, right=right, sim_disp=raw)
            kept = latent_denoise(
                self.unet, self.text_embed, self.spec, self._tables,
                num_inference_steps, num_intermediate_images, conds, lat,
                cond_channels, generator=generator, latents=latents,
                noise_dtype=ref.dtype)
            return latent_decode_images(lambda z: decode_latent(self.vae, z), kept)
