"""The sampling pipelines: the denoise loop with every sampler, the pixel
pipeline, and the latent pipeline's three stages (encode the conditions
once, denoise, decode).

Port of `d3roma_tpu/pipelines/sampling.py`. The JAX package runs the
denoise as one `lax.scan`; here it is a Python loop over the host timestep
table, with the same sampler dispatch: DDPM (`ddpm`, `my_ddpm`), DDIM
(`ddim`, `my_ddim`), Euler and Heun (a second model call at the Euler
point). The pixel pipeline's images are the last step's clamped
prev_sample and its intermediates the kept x_hat0s, clamped; the latent
pipeline's are the VAE decodes of the kept x_hat0 latents (channel mean ->
1 channel), clamped, the last one the final step's.

Noise is explicit: the initial noise (`x_init` / `latents`), the per-step
sampling noise (`step_noise`, one tensor per step, read by the DDPM steps
and the DDIM steps with eta > 0) and, with `add_noise_rgb`, the per-step
noise of the rgb condition (`rgb_noise`) may be given, else they are drawn
from the `torch.Generator` (under `parallel/mesh.py::data_rows`, a data
rank's rows of the whole batch's draw). The JAX package draws them from one key
schedule (`split(key)` for the initial noise, then `split(k, 3)` per step,
the second key the step's noise, the third the rgb condition's), which a
test can replay this way.

`add_noise_rgb` (reference: custom_pipelines.py:343-350): at each step the
rgb slice of the conditions is blended 50/50 with its forward-noised
version at that step's t. The latent family's in-step guidance (the
gradient mode through the VAE decoder) enters the latent denoise as the
steps' `guidance_fn`, as the pixel family's imputation does.

DeepCache (`cache_interval`, `cache_schedule`) runs each step's UNet pass as
the F/S pattern says: a full pass that also returns its trunk where a
shallow step follows, the shallow pass on the latest trunk at an S step.
Heun refuses it (its second model call has no cached pass).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.ops.scheduler_step import ddim_step, ddpm_step, euler_step, heun_correct
from d3roma_tpu_torch.ops.schedules import (
    ScheduleConfig,
    ScheduleTables,
    add_noise,
    set_timesteps,
)
from d3roma_tpu_torch.parallel.mesh import randn_rows

SAMPLER_KINDS = ("ddpm", "my_ddpm", "ddim", "my_ddim", "euler", "heun")


class PipelineOutput(NamedTuple):
    images: torch.Tensor  # [B, H, W, C] final image, clamped
    intermediates: torch.Tensor  # [S, B, H, W, C] x_hat0 (decoded) per kept step


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    kind: str  # one of SAMPLER_KINDS
    schedule: ScheduleConfig
    eta: float = 0.0
    use_clipped_model_output: bool = False

    def __post_init__(self):
        if self.kind not in SAMPLER_KINDS:
            raise ValueError(f"unknown sampler kind {self.kind!r}; supported: {SAMPLER_KINDS}")

    @property
    def is_ddim(self) -> bool:
        return "ddim" in self.kind

    @property
    def is_ode(self) -> bool:
        """The deterministic samplers, which take the latent guidance hook."""
        return self.is_ddim or self.kind in ("euler", "heun")


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


def parse_cache_schedule(schedule: str, num_steps: int) -> tuple:
    """Validate and canonicalize a DeepCache step pattern over {F, S}
    (case-insensitive): F = full UNet pass (refreshes the trunk), S =
    shallow pass on the trunk of the latest F. It must start with F and
    have `num_steps` letters. Returns the segment lengths (one F and its
    trailing S run each): "FSFSFF" -> (2, 2, 1, 1)."""
    s = schedule.strip().upper()
    if not s or set(s) - {"F", "S"}:
        raise ValueError(f"cache_schedule must be a nonempty string over F/S, got "
                         f"{schedule!r}")
    if s[0] != "F":
        raise ValueError(f"cache_schedule must start with F (a shallow step needs a "
                         f"prior full step's trunk), got {schedule!r}")
    if len(s) != num_steps:
        raise ValueError(f"cache_schedule length {len(s)} != num_inference_steps "
                         f"{num_steps}: {schedule!r}")
    segs: List[int] = []
    for c in s:
        if c == "F":
            segs.append(1)
        else:
            segs[-1] += 1
    return tuple(segs)


def uniform_cache_schedule(interval: int, num_steps: int) -> str:
    """The pattern string of the uniform DeepCache interval: groups of one F
    and interval - 1 S, the remainder full steps."""
    k = max(1, int(interval))
    groups, rem = divmod(num_steps, k)
    return ("F" + "S" * (k - 1)) * groups + "F" * rem


def step_pattern(num_steps: int, cache_interval: int = 1,
                 cache_schedule: Optional[str] = None) -> Optional[str]:
    """The F/S pattern the denoise loop follows, or None when every step is
    a plain full pass. An explicit schedule overrides the interval."""
    if cache_schedule is not None:
        parse_cache_schedule(cache_schedule, num_steps)
        pattern = cache_schedule.strip().upper()
    elif cache_interval and cache_interval > 1:
        pattern = uniform_cache_schedule(cache_interval, num_steps)
    else:
        return None
    return pattern if "S" in pattern else None


def _scheduler_apply(spec: SamplerSpec, tables: ScheduleTables, model_output, t: int,
                     prev_t: int, x, generator, noise, guidance_fn):
    """One scheduler update for every sampler but Heun (which needs a
    second model call and stays in the loop)."""
    cfg = spec.schedule
    if spec.is_ddim:
        return ddim_step(tables, cfg, model_output, t, prev_t, x, eta=spec.eta,
                         generator=generator, use_clipped_model_output=spec.use_clipped_model_output,
                         guidance_fn=guidance_fn, noise=noise if spec.eta > 0 else None)
    if spec.kind == "euler":
        return euler_step(tables, cfg, model_output, t, prev_t, x, guidance_fn=guidance_fn)
    if spec.kind in ("ddpm", "my_ddpm"):
        if noise is None and generator is None:
            raise ValueError(f"sampler {spec.kind!r} needs a torch.Generator or step_noise")
        return ddpm_step(tables, cfg, model_output, t, prev_t, x, generator=generator,
                         guidance_fn=guidance_fn, noise=noise)
    raise ValueError(f"unknown sampler kind {spec.kind!r}")


def _step_conds(conds: torch.Tensor, noise_rgb, tables: ScheduleTables, t: int,
                noise: torch.Tensor) -> torch.Tensor:
    """A step's conditions: with `noise_rgb` = (rgb, (start, stop)), the rgb
    slice of `conds` replaced by rgb * 0.5 + add_noise(rgb, noise, t) * 0.5."""
    rgb, (s0, s1) = noise_rgb
    final_rgb = rgb * 0.5 + add_noise(tables, rgb, noise, t) * 0.5
    return torch.cat([conds[..., :s0], final_rgb, conds[..., s1:]], dim=-1)


def run_sampler_steps(
    model_fn: Callable[[torch.Tensor, int], torch.Tensor],
    spec: SamplerSpec,
    tables: ScheduleTables,
    x_init: torch.Tensor,
    conds: torch.Tensor,
    ts,
    prev_ts,
    generator: Optional[torch.Generator] = None,
    cache_interval: int = 1,
    model_fn_trunk=None,
    model_fn_cached=None,
    cache_schedule: Optional[str] = None,
    guidance_fn=None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    noise_rgb=None,
    rgb_noise: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The denoise loop: model_fn(cat([x, conds]), t) -> model output, then
    the sampler's step (Heun: an Euler step, a second model call at
    max(prev_t, 0) on the Euler point, the correction). Returns (final
    sample, guided x_hat0 of every step [S, ...]). `step_noise[i]` is step
    i's sampling noise, else it is drawn from `generator`. `noise_rgb` =
    (rgb, (start, stop)) blends the rgb slice of the conditions with its
    noised version at every step (_step_conds), with `rgb_noise[i]` as step
    i's noise, else drawn from `generator` (before the step's model call).

    With DeepCache (cache_interval > 1 or a cache_schedule with an S), a
    full step followed by an S runs model_fn_trunk(input, t) -> (output,
    trunk) and an S step model_fn_cached(input, t, trunk); other full steps
    run model_fn, as the JAX package's grouped scans do."""
    pattern = step_pattern(len(ts), cache_interval, cache_schedule)
    if pattern is not None:
        if spec.kind == "heun":
            raise ValueError("DeepCache does not support the heun sampler")
        if model_fn_trunk is None or model_fn_cached is None:
            raise ValueError("DeepCache needs model_fn_trunk and model_fn_cached")
    for name, noises in (("step_noise", step_noise), ("rgb_noise", rgb_noise)):
        if noises is not None and len(noises) != len(ts):
            raise ValueError(f"{name} has {len(noises)} entries for {len(ts)} steps")
    if noise_rgb is not None and rgb_noise is None and generator is None:
        raise ValueError("add_noise_rgb needs a torch.Generator or rgb_noise")
    cfg = spec.schedule
    x = x_init
    trunk = None
    x0s: List[torch.Tensor] = []
    for i, (t, prev_t) in enumerate(zip(ts, prev_ts)):
        t, prev_t = int(t), int(prev_t)
        step_conds = conds
        if noise_rgb is not None:
            rgb = noise_rgb[0]
            noise = rgb_noise[i] if rgb_noise is not None else randn_rows(
                rgb.shape, generator, rgb.dtype, rgb.device)
            step_conds = _step_conds(conds, noise_rgb, tables, t, noise)
        model_input = torch.cat([x, step_conds], dim=-1)
        if pattern is not None and pattern[i] == "S":
            out = model_fn_cached(model_input, t, trunk)
        elif pattern is not None and i + 1 < len(pattern) and pattern[i + 1] == "S":
            out, trunk = model_fn_trunk(model_input, t)
        else:
            out = model_fn(model_input, t)
        if spec.kind == "heun":
            e = euler_step(tables, cfg, out, t, prev_t, x, guidance_fn=guidance_fn)
            out2 = model_fn(torch.cat([e.prev_sample, step_conds], dim=-1),
                            max(prev_t, 0))
            step = heun_correct(tables, cfg, out, out2, t, prev_t, x, e.prev_sample,
                                guidance_fn=guidance_fn)
        else:
            noise = None if step_noise is None else step_noise[i]
            step = _scheduler_apply(spec, tables, out, t, prev_t, x, generator, noise,
                                    guidance_fn)
        # the table math runs in fp32; the carry keeps the noise's dtype
        x = step.prev_sample.to(x_init.dtype)
        x0s.append(step.perturbed_original_sample)
    return x, torch.stack(x0s)


def _initial_noise(shape, x_init, generator, dtype, device) -> torch.Tensor:
    if x_init is None:
        return randn_rows(shape, generator, dtype, device)
    if tuple(x_init.shape) != tuple(shape):
        raise ValueError(f"initial noise {tuple(x_init.shape)} != {tuple(shape)}")
    return x_init.to(device)


def _kept(stack: torch.Tensor, num_inference_steps: int,
          num_intermediate_images: int) -> torch.Tensor:
    # views stacked, not an index tensor: no host-to-device copy, no sync
    return torch.stack([stack[int(i)] for i in _kept_indices(num_inference_steps,
                                                              num_intermediate_images)])


def pixel_pipeline(
    unet_apply: Callable[[torch.Tensor, int], torch.Tensor],
    spec: SamplerSpec,
    tables: ScheduleTables,
    num_inference_steps: int,
    num_intermediate_images: int,
    depth_channels: int,
    cond_channels: str,
    rgb: Optional[torch.Tensor] = None,
    left: Optional[torch.Tensor] = None,
    right: Optional[torch.Tensor] = None,
    sim_disp: Optional[torch.Tensor] = None,
    guidance: Optional[FlowGuidance] = None,
    raw_mask: Optional[torch.Tensor] = None,
    add_noise_rgb: bool = False,
    generator: Optional[torch.Generator] = None,
    x_init: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    rgb_noise: Optional[Sequence[torch.Tensor]] = None,
) -> PipelineOutput:
    """Pixel-space sampling, NHWC at full resolution: noise at image size
    ([B, H, W, depth_channels], `x_init` or drawn from `generator` in the
    reference image's dtype), the denoise loop, then the last step's
    prev_sample clamped to [-1, 1] as the images and the kept x_hat0s,
    clamped, as the intermediates. With an enabled `guidance` and a raw
    condition, the imputation hook replaces x_hat0 by the raw disparity
    where `raw_mask` (default: sim_disp != 0) is set. `add_noise_rgb` with
    an rgb condition first in `cond_channels`: see run_sampler_steps."""
    ref = next(x for x in (rgb, left) if x is not None)
    B, H, W, _ = ref.shape
    conds = build_cond_concat(cond_channels, rgb, left, right, sim_disp)
    x_init = _initial_noise((B, H, W, depth_channels), x_init, generator, ref.dtype, ref.device)

    guidance_fn = None
    if guidance is not None and guidance.enabled and sim_disp is not None:
        if guidance.flow_guidance_mode != "imputation":
            raise NotImplementedError(f"pixel pipeline supports only imputation guidance, "
                                      f"got {guidance.flow_guidance_mode!r}")
        # the fallback mask is right only where invalid raw pixels normalize
        # to exactly 0 (SSI); other normalizers need the real raw_mask
        mask = raw_mask if raw_mask is not None else (sim_disp != 0)
        guidance_fn = guidance.make_pixel_imputation_fn(sim_disp[..., :depth_channels],
                                                        mask[..., :depth_channels])

    noise_rgb = None
    if add_noise_rgb and rgb is not None and cond_channels.startswith("rgb"):
        noise_rgb = (rgb, (0, rgb.shape[-1]))
    ts, prev_ts = _timestep_arrays(spec.schedule, num_inference_steps)
    final, stack = run_sampler_steps(unet_apply, spec, tables, x_init, conds, ts, prev_ts,
                                     generator, guidance_fn=guidance_fn, step_noise=step_noise,
                                     noise_rgb=noise_rgb, rgb_noise=rgb_noise)
    inter = _kept(stack, num_inference_steps, num_intermediate_images).clamp(-1.0, 1.0)
    return PipelineOutput(final.clamp(-1.0, 1.0), inter)


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
    cache_interval: int = 1,
    unet_apply_trunk=None,
    unet_apply_cached=None,
    cache_schedule: Optional[str] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    guidance_fn=None,
    add_noise_rgb: bool = False,
    rgb_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Stage 2: initial latent noise, then the denoise loop. Returns the kept
    x_hat0 latents [S, B, h, w, 4] (the last is the final step's).
    DeepCache: `unet_apply_trunk(input, t, ctx) -> (out, trunk)` and
    `unet_apply_cached(input, t, ctx, trunk) -> out`, see run_sampler_steps.

    `latents` is the initial noise [B, h, w, 4] (the diffusers idiom);
    without it the noise is drawn from `generator`, in `noise_dtype` (the
    input images' dtype in the pipeline). `step_noise`, `guidance_fn` (the
    in-step hook of the ODE steps) and `rgb_noise`: see run_sampler_steps;
    `add_noise_rgb` blends the rgb condition's latent where the conditions
    hold one."""
    shape = tuple(conds.shape[:-1]) + (4,)
    x_init = _initial_noise(shape, latents, generator, noise_dtype or conds.dtype,
                            conds.device)
    B = conds.shape[0]
    if text_embed.shape[0] == 1 and B > 1:
        text_embed = text_embed.expand((B,) + tuple(text_embed.shape[1:]))

    def model_fn(model_input, t):
        return unet_apply(model_input, t, text_embed)

    def model_fn_trunk(model_input, t):
        return unet_apply_trunk(model_input, t, text_embed)

    def model_fn_cached(model_input, t, trunk):
        return unet_apply_cached(model_input, t, text_embed, trunk)

    noise_rgb = None
    if add_noise_rgb and "rgb" in lat and "rgb" in cond_channels:
        noise_rgb = (lat["rgb"], (0, lat["rgb"].shape[-1]))
    ts, prev_ts = _timestep_arrays(spec.schedule, num_inference_steps)
    _, x0_stack = run_sampler_steps(
        model_fn, spec, tables, x_init, conds, ts, prev_ts, generator,
        cache_interval=cache_interval, model_fn_trunk=model_fn_trunk,
        model_fn_cached=model_fn_cached, cache_schedule=cache_schedule,
        guidance_fn=guidance_fn, step_noise=step_noise, noise_rgb=noise_rgb,
        rgb_noise=rgb_noise)
    return _kept(x0_stack, num_inference_steps, num_intermediate_images)


def latent_decode_images(vae_decode: Callable[[torch.Tensor], torch.Tensor],
                         kept: torch.Tensor) -> PipelineOutput:
    """Stage 3: one batched decode of the kept x_hat0 latents."""
    s, b = kept.shape[:2]
    decoded = vae_decode(kept.reshape((s * b,) + tuple(kept.shape[2:])))
    inter = decoded.reshape((s, b) + tuple(decoded.shape[1:])).clamp(-1.0, 1.0)
    return PipelineOutput(inter[-1], inter)
