"""The reverse-process steps: DDPM, DDIM, Euler and Heun.

Port of `d3roma_tpu/ops/scheduler_step.py`. The sampling loop is a Python
loop over host timesteps, so `t` and `prev_t` are Python ints here (a [B]
tensor also works where the JAX package takes one); the table math runs in
float32 on the tables' device, in the JAX functions' order of operations.

The in-step guidance hook is `guidance_fn(pred_x0, t) -> x0`, applied to the
(clipped) x_hat0 before the posterior mean is formed; a step returns the
guided x_hat0 as `perturbed_original_sample`.

The sampling noise of DDPM (and of DDIM with eta > 0) is the explicit
`noise` tensor when one is given (a test feeds the JAX package's), else it
is drawn from `generator` in the sample's dtype (a data rank's rows of the
whole batch's draw under `parallel/mesh.py::data_rows`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from d3roma_tpu_torch.ops.schedules import ScheduleConfig, ScheduleTables, extract
from d3roma_tpu_torch.parallel.mesh import randn_rows

GuidanceFn = Callable[[torch.Tensor, Union[int, torch.Tensor]], torch.Tensor]


class StepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor
    perturbed_original_sample: torch.Tensor


def predict_x0_and_eps(cfg: ScheduleConfig, model_output: torch.Tensor,
                       sample: torch.Tensor, alpha_prod_t: torch.Tensor):
    """Reconstruct (x0, epsilon) from the model output for every prediction
    type (`v_pred_depth` samples like v-prediction)."""
    sqrt_a = torch.sqrt(alpha_prod_t)
    sqrt_b = torch.sqrt(1.0 - alpha_prod_t)
    if cfg.prediction_type == "epsilon":
        return (sample - sqrt_b * model_output) / sqrt_a, model_output
    if cfg.prediction_type == "sample":
        return model_output, (sample - sqrt_a * model_output) / sqrt_b
    if cfg.prediction_type in ("v_prediction", "v_pred_depth"):
        return (sqrt_a * sample - sqrt_b * model_output,
                sqrt_a * model_output + sqrt_b * sample)
    raise ValueError(f"unknown prediction_type: {cfg.prediction_type!r}")


def dynamic_threshold(x0: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen dynamic thresholding: per-sample quantile of |x0|, clamped to
    [1, max_value]; x0 is clipped to [-s, s] and divided by s."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs().float(), ratio, dim=1)
    s = s.clamp(1.0, max_value).reshape((b,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def _maybe_clip(cfg: ScheduleConfig, x0: torch.Tensor) -> torch.Tensor:
    if cfg.thresholding:
        return dynamic_threshold(x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    if cfg.clip_sample:
        return x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
    return x0


def _broadcast_mask(mask, ndim: int):
    if not isinstance(mask, torch.Tensor) or mask.ndim == 0:
        return mask
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def _prev_alpha(tables: ScheduleTables, prev_t, ndim: int, final) -> torch.Tensor:
    """alpha_bar[prev_t], or `final` where prev_t < 0 (1.0 for DDPM,
    final_alpha_cumprod for DDIM, Euler and Heun)."""
    if not isinstance(final, torch.Tensor):  # filled on the device: no host copy
        final = torch.full((), final, dtype=torch.float32, device=tables.alphas_cumprod.device)
    if isinstance(prev_t, int):
        return extract(tables.alphas_cumprod, prev_t, ndim) if prev_t >= 0 else final
    ab_prev = extract(tables.alphas_cumprod, prev_t.clamp(min=0), ndim)
    return torch.where(_broadcast_mask(prev_t >= 0, ndim), ab_prev, final)


def _noise_like(sample: torch.Tensor, noise: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(sample.shape):
            raise ValueError(f"noise {tuple(noise.shape)} != sample {tuple(sample.shape)}")
        return noise.to(sample.device, sample.dtype)
    return randn_rows(sample.shape, generator, sample.dtype, sample.device)


def ddpm_step(
    tables: ScheduleTables,
    cfg: ScheduleConfig,
    model_output: torch.Tensor,
    t,
    prev_t,
    sample: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    guidance_fn: Optional[GuidanceFn] = None,
    variance_output: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> StepOutput:
    """One ancestral DDPM step x_t -> x_{prev_t} (prev_t < 0 at the last
    step). The posterior coefficients come from alpha_bar[t] and
    alpha_bar[prev_t], so spaced sampling is exact. Without `noise` and
    `generator` the step adds no noise (the posterior mean); the noise is
    masked off at t == 0. `variance_output` carries the model's predicted
    (log-)variance for the learned modes."""
    nd = sample.ndim
    alpha_prod_t = extract(tables.alphas_cumprod, t, nd)
    alpha_prod_t_prev = _prev_alpha(tables, prev_t, nd, 1.0)
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_t_prev = 1.0 - alpha_prod_t_prev
    current_alpha_t = alpha_prod_t / alpha_prod_t_prev
    current_beta_t = 1.0 - current_alpha_t

    pred_x0, _ = predict_x0_and_eps(cfg, model_output, sample, alpha_prod_t)
    pred_x0 = _maybe_clip(cfg, pred_x0)
    perturbed_x0 = guidance_fn(pred_x0, t) if guidance_fn is not None else pred_x0

    coef_x0 = torch.sqrt(alpha_prod_t_prev) * current_beta_t / beta_prod_t
    coef_xt = torch.sqrt(current_alpha_t) * beta_prod_t_prev / beta_prod_t
    prev_sample = coef_x0 * perturbed_x0 + coef_xt * sample

    if noise is not None or generator is not None:
        std = _ddpm_std(cfg, alpha_prod_t, alpha_prod_t_prev, current_beta_t,
                        variance_output)
        add = std * _noise_like(sample, noise, generator)
        if isinstance(t, int):
            if t > 0:
                prev_sample = prev_sample + add
        else:
            prev_sample = prev_sample + torch.where(_broadcast_mask(t > 0, nd), add,
                                                    torch.zeros_like(add))
    return StepOutput(prev_sample, pred_x0, perturbed_x0)


def _ddpm_std(cfg: ScheduleConfig, alpha_prod_t, alpha_prod_t_prev, current_beta_t,
              variance_output: Optional[torch.Tensor]) -> torch.Tensor:
    """The standard deviation of the sampling noise per variance_type."""
    variance = (1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t) * current_beta_t
    variance = variance.clamp(min=1e-20)
    vt = cfg.variance_type
    if vt == "fixed_small":
        return torch.sqrt(variance)
    if vt == "fixed_small_log":
        return torch.exp(0.5 * torch.log(variance))
    if vt == "fixed_large":
        return torch.sqrt(current_beta_t.clamp(min=1e-20))
    if vt == "fixed_large_log":
        return torch.exp(0.5 * torch.log(current_beta_t.clamp(min=1e-20)))
    if vt in ("learned", "learned_range") and variance_output is None:
        raise ValueError(f"variance_type {vt!r} needs the model's variance_output")
    if vt == "learned":
        # a raw variance, not a log-variance as in learned_range
        return torch.sqrt(variance_output.clamp(min=0.0))
    if vt == "learned_range":
        min_log = torch.log(variance)
        max_log = torch.log(current_beta_t.clamp(min=1e-20))
        frac = (variance_output + 1.0) / 2.0
        return torch.exp(0.5 * (frac * max_log + (1.0 - frac) * min_log))
    raise ValueError(f"unknown variance_type: {vt!r}")


def ddim_step(
    tables: ScheduleTables,
    cfg: ScheduleConfig,
    model_output: torch.Tensor,
    t,
    prev_t,
    sample: torch.Tensor,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    use_clipped_model_output: bool = False,
    guidance_fn: Optional[GuidanceFn] = None,
    noise: Optional[torch.Tensor] = None,
) -> StepOutput:
    """One DDIM step (eqs. 12/16 of Song et al.). `prev_t` < 0 takes
    `final_alpha_cumprod` (alphas_cumprod[0] with set_alpha_to_one=False)."""
    nd = sample.ndim
    alpha_prod_t = extract(tables.alphas_cumprod, t, nd)
    alpha_prod_t_prev = _prev_alpha(tables, prev_t, nd, tables.final_alpha_cumprod)
    beta_prod_t = 1.0 - alpha_prod_t

    pred_x0, pred_eps = predict_x0_and_eps(cfg, model_output, sample, alpha_prod_t)
    pred_x0 = _maybe_clip(cfg, pred_x0)
    perturbed_x0 = guidance_fn(pred_x0, t) if guidance_fn is not None else pred_x0
    if use_clipped_model_output:
        pred_eps = (sample - torch.sqrt(alpha_prod_t) * perturbed_x0) / torch.sqrt(beta_prod_t)

    variance = ((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)
                * (1.0 - alpha_prod_t / alpha_prod_t_prev))
    std_dev_t = eta * torch.sqrt(variance.clamp(min=0.0))
    direction = torch.sqrt((1.0 - alpha_prod_t_prev - std_dev_t**2).clamp(min=0.0)) * pred_eps
    prev_sample = torch.sqrt(alpha_prod_t_prev) * perturbed_x0 + direction
    if eta > 0.0:
        if generator is None and noise is None:
            raise ValueError("eta > 0 requires a torch.Generator or explicit noise")
        prev_sample = prev_sample + std_dev_t * _noise_like(sample, noise, generator)
    return StepOutput(prev_sample, pred_x0, perturbed_x0)


def sigma_of(alpha_prod: torch.Tensor) -> torch.Tensor:
    """VP-SDE noise level sigma = sqrt((1 - abar) / abar)."""
    return torch.sqrt((1.0 - alpha_prod) / alpha_prod)


def euler_step(
    tables: ScheduleTables,
    cfg: ScheduleConfig,
    model_output: torch.Tensor,
    t,
    prev_t,
    sample: torch.Tensor,
    guidance_fn: Optional[GuidanceFn] = None,
) -> StepOutput:
    """First-order Euler step of the probability-flow ODE in sigma space,
    computed in its VP form (the DDIM eta = 0 update with epsilon re-derived
    from the guided x0), which stays finite at alpha_bar == 0 (the zero-SNR
    terminal step)."""
    nd = sample.ndim
    alpha_prod_t = extract(tables.alphas_cumprod, t, nd)
    alpha_prod_t_prev = _prev_alpha(tables, prev_t, nd, tables.final_alpha_cumprod)

    pred_x0, _ = predict_x0_and_eps(cfg, model_output, sample, alpha_prod_t)
    pred_x0 = _maybe_clip(cfg, pred_x0)
    perturbed_x0 = guidance_fn(pred_x0, t) if guidance_fn is not None else pred_x0

    eps_pert = (sample - torch.sqrt(alpha_prod_t) * perturbed_x0) / torch.sqrt(
        (1.0 - alpha_prod_t).clamp(min=1e-12))
    prev_sample = (torch.sqrt(alpha_prod_t_prev) * perturbed_x0
                   + torch.sqrt((1.0 - alpha_prod_t_prev).clamp(min=0.0)) * eps_pert)
    return StepOutput(prev_sample, pred_x0, perturbed_x0)


def heun_correct(
    tables: ScheduleTables,
    cfg: ScheduleConfig,
    model_output_t: torch.Tensor,
    model_output_prev: torch.Tensor,
    t,
    prev_t,
    sample: torch.Tensor,
    euler_prev_sample: torch.Tensor,
    guidance_fn: Optional[GuidanceFn] = None,
) -> StepOutput:
    """Second-order Heun correction: the mean of the ODE derivatives at
    (t, x_t) and at (prev_t, x_euler), both with the guidance hook. Falls
    back to the Euler result where the correction is undefined: at the last
    step (sigma_prev == 0) and from the zero-SNR terminal (alpha_bar == 0)."""
    nd = sample.ndim
    alpha_prod_t = extract(tables.alphas_cumprod, t, nd)
    alpha_prod_t_prev = _prev_alpha(tables, prev_t, nd, tables.final_alpha_cumprod)
    sigma_prev = sigma_of(alpha_prod_t_prev)

    pred_x0, _ = predict_x0_and_eps(cfg, model_output_t, sample, alpha_prod_t)
    pred_x0 = _maybe_clip(cfg, pred_x0)
    perturbed_x0 = guidance_fn(pred_x0, t) if guidance_fn is not None else pred_x0
    safe_alpha = alpha_prod_t.clamp(min=1e-12)
    safe_sigma = sigma_of(safe_alpha)
    x_hat = sample / torch.sqrt(safe_alpha)
    d1 = (x_hat - perturbed_x0) / safe_sigma

    safe_prev_alpha = alpha_prod_t_prev.clamp(min=1e-12)
    x_hat_prev = euler_prev_sample / torch.sqrt(safe_prev_alpha)
    pred_x0_2, _ = predict_x0_and_eps(cfg, model_output_prev, euler_prev_sample,
                                      alpha_prod_t_prev)
    pred_x0_2 = _maybe_clip(cfg, pred_x0_2)
    if guidance_fn is not None:
        pred_x0_2 = guidance_fn(pred_x0_2, prev_t)
    d2 = (x_hat_prev - pred_x0_2) / sigma_prev.clamp(min=1e-12)

    d_avg = 0.5 * (d1 + d2)
    heun_prev = (x_hat + (sigma_prev - safe_sigma) * d_avg) * torch.sqrt(alpha_prod_t_prev)
    use_heun = (sigma_prev > 1e-10) & (alpha_prod_t > 1e-10)
    prev_sample = torch.where(use_heun, heun_prev, euler_prev_sample)
    return StepOutput(prev_sample, pred_x0, perturbed_x0)


def posterior_mean_variance(tables: ScheduleTables, x0: torch.Tensor, x_t: torch.Tensor, t):
    """q(x_{t-1} | x_t, x_0) over training timesteps: (mean, variance,
    clipped log-variance)."""
    nd = x_t.ndim
    mean = (extract(tables.posterior_mean_coef1, t, nd) * x0
            + extract(tables.posterior_mean_coef2, t, nd) * x_t)
    return (mean, extract(tables.posterior_variance, t, nd),
            extract(tables.posterior_log_variance_clipped, t, nd))
