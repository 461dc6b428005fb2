"""The latent sampling pipeline: encode the conditions once, denoise, decode.

Port of the latent path of `d3roma_tpu/pipelines/sampling.py`. The JAX
package runs the denoise as one `lax.scan`; here it is a Python loop over
the host timestep table. The returned images are the VAE decodes of the
kept x_hat0 latents (channel mean -> 1 channel), clamped to [-1, 1]; the
last one is the final step's.

Only the DDIM samplers (eta 0 or with a generator) are ported; DDPM,
euler, heun, DeepCache, guidance and add_noise_rgb wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from d3roma_tpu_torch.ops.scheduler_step import ddim_step
from d3roma_tpu_torch.ops.schedules import ScheduleConfig, ScheduleTables, set_timesteps

SAMPLER_KINDS = ("ddim", "my_ddim")
_NOT_PORTED_KINDS = ("ddpm", "my_ddpm", "euler", "heun")


class PipelineOutput(NamedTuple):
    images: torch.Tensor  # [B, H, W, C] final decoded x_hat0, clamped
    intermediates: torch.Tensor  # [S, B, H, W, C] decoded x_hat0 per kept step


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    kind: str  # one of SAMPLER_KINDS
    schedule: ScheduleConfig
    eta: float = 0.0
    use_clipped_model_output: bool = False

    def __post_init__(self):
        if self.kind in _NOT_PORTED_KINDS:
            raise NotImplementedError(f"sampler {self.kind!r} is not ported yet; "
                                      f"ported: {SAMPLER_KINDS}")
        if self.kind not in SAMPLER_KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}")


def build_cond_concat(cond_channels: str, rgb=None, left=None, right=None,
                      raw=None) -> torch.Tensor:
    """Channel-concat of the conditions named by `cond_channels` (NHWC)."""
    parts = {
        "rgb": [rgb],
        "rgb+raw": [rgb, raw],
        "left+right": [left, right],
        "left+right+raw": [left, right, raw],
        "rgb+left+right": [rgb, left, right],
        "rgb+left+right+raw": [rgb, left, right, raw],
    }
    if cond_channels not in parts:
        raise ValueError(f"Unknown cond_channels: {cond_channels}")
    chosen = parts[cond_channels]
    if any(p is None for p in chosen):
        raise ValueError(f"missing conditions for {cond_channels}")
    return torch.cat(chosen, dim=-1)


def _timestep_arrays(schedule: ScheduleConfig, num_inference_steps: int):
    """(timesteps, previous timesteps) as host ints. The previous timestep is
    t - T // S, the reference steppers' convention, not the next element of
    the spaced sequence (the two differ under linspace spacing)."""
    ts = set_timesteps(schedule, num_inference_steps).astype(np.int64)
    return ts, ts - schedule.num_train_timesteps // num_inference_steps


def _kept_indices(num_inference_steps: int, num_intermediate_images: int) -> np.ndarray:
    """Every T // num_intermediate_images-th step, the last step always kept."""
    every = max(1, num_inference_steps // max(1, num_intermediate_images))
    idx = np.arange(every - 1, num_inference_steps, every)
    if len(idx) == 0 or idx[-1] != num_inference_steps - 1:
        idx = np.append(idx, num_inference_steps - 1)
    return idx


def run_sampler_steps(
    model_fn: Callable[[torch.Tensor, int], torch.Tensor],
    spec: SamplerSpec,
    tables: ScheduleTables,
    x_init: torch.Tensor,
    conds: torch.Tensor,
    ts,
    prev_ts,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The denoise loop: model_fn(cat([x, conds]), t) -> model output, then
    a DDIM step. Returns (final sample, x_hat0 of every step [S, ...])."""
    x = x_init
    x0s: List[torch.Tensor] = []
    for t, prev_t in zip(ts, prev_ts):
        out = model_fn(torch.cat([x, conds], dim=-1), int(t))
        step = ddim_step(tables, spec.schedule, out, int(t), int(prev_t), x, eta=spec.eta,
                         generator=generator,
                         use_clipped_model_output=spec.use_clipped_model_output)
        # the table math runs in fp32; the carry keeps the noise's dtype
        x = step.prev_sample.to(x_init.dtype)
        x0s.append(step.perturbed_original_sample)
    return x, torch.stack(x0s)


def latent_encode_conds(
    vae_encode: Callable[[torch.Tensor], torch.Tensor],
    cond_channels: str,
    rgb: Optional[torch.Tensor] = None,
    left: Optional[torch.Tensor] = None,
    right: Optional[torch.Tensor] = None,
    sim_disp: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage 1: one batched VAE encode of every condition (disparity tiled
    to 3 channels first). Returns the channel-concat condition latents and
    the per-name latents."""
    to_encode, names = [], []
    for name, img in (("rgb", rgb), ("left", left), ("right", right)):
        if img is not None:
            to_encode.append(img)
            names.append(name)
    if sim_disp is not None:
        to_encode.append(sim_disp.repeat(1, 1, 1, 3))
        names.append("raw")
    encoded = vae_encode(torch.cat(to_encode, dim=0))
    lat = dict(zip(names, encoded.chunk(len(names), dim=0)))
    conds = build_cond_concat(cond_channels, lat.get("rgb"), lat.get("left"),
                              lat.get("right"), lat.get("raw"))
    return conds, lat


def latent_denoise(
    unet_apply: Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor],
    text_embed: torch.Tensor,
    spec: SamplerSpec,
    tables: ScheduleTables,
    num_inference_steps: int,
    num_intermediate_images: int,
    conds: torch.Tensor,
    lat: Dict[str, torch.Tensor],
    cond_channels: str,
    generator: Optional[torch.Generator] = None,
    latents: Optional[torch.Tensor] = None,
    noise_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Stage 2: initial latent noise, then the denoise loop. Returns the kept
    x_hat0 latents [S, B, h, w, 4] (the last is the final step's).

    `latents` is the initial noise [B, h, w, 4] (the diffusers idiom);
    without it the noise is drawn from `generator`, in `noise_dtype` (the
    input images' dtype in the pipeline)."""
    shape = tuple(conds.shape[:-1]) + (4,)
    if latents is None:
        x_init = torch.randn(shape, generator=generator,
                             dtype=noise_dtype or conds.dtype, device=conds.device)
    else:
        if tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        x_init = latents.to(conds.device)
    B = conds.shape[0]
    if text_embed.shape[0] == 1 and B > 1:
        text_embed = text_embed.expand((B,) + tuple(text_embed.shape[1:]))

    def model_fn(model_input, t):
        return unet_apply(model_input, t, text_embed)

    ts, prev_ts = _timestep_arrays(spec.schedule, num_inference_steps)
    _, x0_stack = run_sampler_steps(model_fn, spec, tables, x_init, conds, ts, prev_ts,
                                    generator)
    kept = _kept_indices(num_inference_steps, num_intermediate_images)
    return x0_stack[torch.as_tensor(kept, device=x0_stack.device)]


def latent_decode_images(vae_decode: Callable[[torch.Tensor], torch.Tensor],
                         kept: torch.Tensor) -> PipelineOutput:
    """Stage 3: one batched decode of the kept x_hat0 latents."""
    s, b = kept.shape[:2]
    decoded = vae_decode(kept.reshape((s * b,) + tuple(kept.shape[2:])))
    inter = decoded.reshape((s, b) + tuple(decoded.shape[1:])).clamp(-1.0, 1.0)
    return PipelineOutput(inter[-1], inter)
