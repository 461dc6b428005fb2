"""The DDIM reverse-process step.

Port of `ddim_step` and `predict_x0_and_eps` from
`d3roma_tpu/ops/scheduler_step.py`. The sampling loop is a Python loop over
host timesteps, so `t` and `prev_t` are Python ints here; the table math
runs in float32 on the tables' device. DDPM, euler and heun are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from d3roma_tpu_torch.ops.schedules import ScheduleConfig, ScheduleTables, extract


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


def ddim_step(
    tables: ScheduleTables,
    cfg: ScheduleConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    use_clipped_model_output: bool = False,
) -> StepOutput:
    """One DDIM step (eqs. 12/16 of Song et al.). `prev_t` < 0 takes
    `final_alpha_cumprod` (alphas_cumprod[0] with set_alpha_to_one=False)."""
    nd = sample.ndim
    alpha_prod_t = extract(tables.alphas_cumprod, t, nd)
    alpha_prod_t_prev = (extract(tables.alphas_cumprod, prev_t, nd) if prev_t >= 0
                         else tables.final_alpha_cumprod)
    beta_prod_t = 1.0 - alpha_prod_t

    pred_x0, pred_eps = predict_x0_and_eps(cfg, model_output, sample, alpha_prod_t)
    pred_x0 = _maybe_clip(cfg, pred_x0)
    if use_clipped_model_output:
        pred_eps = (sample - torch.sqrt(alpha_prod_t) * pred_x0) / torch.sqrt(beta_prod_t)

    variance = ((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)
                * (1.0 - alpha_prod_t / alpha_prod_t_prev))
    std_dev_t = eta * torch.sqrt(variance.clamp(min=0.0))
    direction = torch.sqrt((1.0 - alpha_prod_t_prev - std_dev_t**2).clamp(min=0.0)) * pred_eps
    prev_sample = torch.sqrt(alpha_prod_t_prev) * pred_x0 + direction
    if eta > 0.0:
        if generator is None:
            raise ValueError("eta > 0 requires a torch.Generator")
        noise = torch.randn(sample.shape, generator=generator, dtype=sample.dtype,
                            device=sample.device)
        prev_sample = prev_sample + std_dev_t * noise
    return StepOutput(prev_sample, pred_x0, pred_x0)
