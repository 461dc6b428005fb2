"""Noise-schedule tables for diffusion.

Port of `d3roma_tpu/ops/schedules.py`. The tables are computed once on the
host in float64 numpy and stored as float32 tensors on the caller's device,
as the JAX package stores them as float32 device arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from d3roma_tpu_torch.device import DeviceLike, resolve_device


def make_betas(
    num_train_timesteps: int,
    beta_schedule: str = "linear",
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    max_beta: float = 0.999,
) -> np.ndarray:
    """Beta table for the forward process, float64."""
    T = num_train_timesteps
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, T, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.array(
            [min(1.0 - alpha_bar((i + 1) / T) / alpha_bar(i / T), max_beta)
             for i in range(T)],
            dtype=np.float64,
        )
    if beta_schedule == "sigmoid":
        betas = 1.0 / (1.0 + np.exp(-np.linspace(-6.0, 6.0, T, dtype=np.float64)))
        return betas * (beta_end - beta_start) + beta_start
    raise ValueError(f"unknown beta_schedule: {beta_schedule!r}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift and scale alpha-bar so the terminal SNR is exactly zero."""
    sqrt_ab = np.sqrt(np.cumprod(1.0 - betas))
    ab_0, ab_T = sqrt_ab[0].copy(), sqrt_ab[-1].copy()
    sqrt_ab = (sqrt_ab - ab_T) * ab_0 / (ab_0 - ab_T)
    alphas_cumprod = sqrt_ab**2
    alphas = np.concatenate(
        [alphas_cumprod[:1], alphas_cumprod[1:] / alphas_cumprod[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Static diffusion schedule configuration (same fields and defaults as
    the JAX package's ScheduleConfig)."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"
    beta_start: float = 0.0001
    beta_end: float = 0.02
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    variance_type: str = "fixed_small"  # DDPM only
    timestep_spacing: str = "leading"
    steps_offset: int = 0
    set_alpha_to_one: bool = False  # DDIM final-alpha convention
    rescale_betas_zero_snr: bool = False

    def tables(self, device: DeviceLike = None) -> "ScheduleTables":
        return ScheduleTables.create(self, device)


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Per-timestep tables as float32 tensors (all shape [T])."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    # alpha_bar used where the previous timestep is < 0 (scalar): 1.0 if
    # set_alpha_to_one else alphas_cumprod[0]
    final_alpha_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @staticmethod
    def create(cfg: ScheduleConfig, device: DeviceLike = None) -> "ScheduleTables":
        dev = resolve_device(device)
        betas = make_betas(cfg.num_train_timesteps, cfg.beta_schedule,
                           cfg.beta_start, cfg.beta_end)
        if cfg.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas = 1.0 - betas
        ab = np.cumprod(alphas)
        ab_prev = np.concatenate([[1.0], ab[:-1]])
        post_var = betas * (1.0 - ab_prev) / (1.0 - ab)
        post_log_var = np.log(np.concatenate([[post_var[1]], post_var[1:]]))
        final_ab = 1.0 if cfg.set_alpha_to_one else float(ab[0])

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return ScheduleTables(
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_cumprod=f32(ab),
            sqrt_alphas_cumprod=f32(np.sqrt(ab)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ab)),
            final_alpha_cumprod=f32(final_ab),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_log_var),
            posterior_mean_coef1=f32(betas * np.sqrt(ab_prev) / (1.0 - ab)),
            posterior_mean_coef2=f32((1.0 - ab_prev) * np.sqrt(alphas) / (1.0 - ab)),
        )


def set_timesteps(
    cfg: ScheduleConfig,
    num_inference_steps: int,
    timesteps: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Inference timestep sequence (descending) as host int32."""
    T = cfg.num_train_timesteps
    if timesteps is not None:
        ts = np.asarray(sorted(set(int(t) for t in timesteps), reverse=True))
        if ts.size == 0:
            raise ValueError("custom timesteps must be non-empty")
        if ts.max() >= T or ts.min() < 0:
            raise ValueError(f"custom timesteps out of range [0, {T})")
        return ts.astype(np.int32)
    if num_inference_steps > T:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) > num_train_timesteps ({T})")
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        # steps == T with steps_offset=1 yields timestep T; extract() clamps
        # it to T-1 as the JAX package's jnp.take does
        ts += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {cfg.timestep_spacing!r}")
    return ts.astype(np.int32)


def extract(table: torch.Tensor, t, broadcast_ndim: int) -> torch.Tensor:
    """Gather per-timestep values, shaped to broadcast against an NHWC
    tensor: a Python int or 0-d t gives a 0-d tensor, a [B] t gives
    [B, 1, ..., 1] with `broadcast_ndim` dims. Indices are clamped to the
    table, as jnp.take clamps them."""
    last = table.shape[0] - 1
    if isinstance(t, int):
        return table[min(max(t, 0), last)]
    vals = table[t.to(table.device).long().clamp(0, last)]
    if vals.ndim == 0:
        return vals
    return vals.reshape(vals.shape + (1,) * (broadcast_ndim - vals.ndim))


def add_noise(tables: ScheduleTables, x0: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    """Forward process q(x_t | x_0)."""
    a = extract(tables.sqrt_alphas_cumprod, t, x0.ndim)
    b = extract(tables.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
    return a * x0 + b * noise


def get_velocity(tables: ScheduleTables, x0: torch.Tensor, noise: torch.Tensor,
                 t) -> torch.Tensor:
    """The v-prediction target sqrt(ab) * noise - sqrt(1 - ab) * x0."""
    a = extract(tables.sqrt_alphas_cumprod, t, x0.ndim)
    b = extract(tables.sqrt_one_minus_alphas_cumprod, t, x0.ndim)
    return a * noise - b * x0


def snr(tables: ScheduleTables, t) -> torch.Tensor:
    """Signal-to-noise ratio alpha_bar / (1 - alpha_bar) at timestep t."""
    ab = extract(tables.alphas_cumprod, t, 1)
    return ab / (1.0 - ab)
