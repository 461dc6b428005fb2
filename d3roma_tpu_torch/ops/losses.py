"""Likelihood and perceptual loss helpers.

Port of `d3roma_tpu/ops/losses.py`: the iDDPM VLB terms (reference:
utils_d3roma/losess.py:10-91) and the SSIM distance of the photometric
guidance (reference: core/guidance.py:12-42).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _as_float(v, like: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(like.dtype, torch.float32)
    return torch.as_tensor(v, dtype=dt, device=like.device)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)), broadcast."""
    logvar1 = _as_float(logvar1, torch.as_tensor(mean1))
    logvar2 = _as_float(logvar2, torch.as_tensor(mean2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 255-level bins, for
    images in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def mse_to_vlb(t: torch.Tensor, mse: torch.Tensor, logvar_clipped: torch.Tensor) -> torch.Tensor:
    """Per-timestep MSE as a VLB proxy term (reference:
    utils_d3roma/losess.py:10-23). t [B] int, mse [B], logvar_clipped [T]."""
    lv = logvar_clipped[torch.clamp(t, min=1)]
    return 0.5 * mse * torch.exp(-lv) / math.log(2.0)


def ssim(x: torch.Tensor, y: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """The SSIM distance map (1 - SSIM) / 2, clipped to [0, 1], with 3x3
    mean pooling over edge-padded NHWC images (reference:
    core/guidance.py:12-42)."""
    def pad(z):
        return F.pad(z.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")

    def pool(z):  # the 3x3 window sum over 9, as the JAX reduce_window
        return (F.avg_pool2d(z, 3, stride=1, divisor_override=1) / 9.0)

    xp, yp = pad(x), pad(y)
    mu_x, mu_y = pool(xp), pool(yp)
    sigma_x = pool(xp**2) - mu_x**2
    sigma_y = pool(yp**2) - mu_y**2
    sigma_xy = pool(xp * yp) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)
