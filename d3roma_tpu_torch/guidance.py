"""Test-time flow guidance.

Port of `d3roma_tpu/guidance.py` (reference: core/guidance.py:91-392):

- ``gradient``: the release path of the latent model. Inside each denoise
  step, `num_opt_steps` Adam steps (optax's `adam` arithmetic) move the
  latent x_hat0 so that its VAE decode, denormalized, L1-matches the raw
  sensor depth where that is valid (reference: guidance.py:214-244);
- ``imputation``: pixel space only, x_hat0 replaced by the normalized raw
  disparity where the sensor saw something (the latent family refuses it,
  as in custom_pipelines.py:392);
- photometric ``photometric_grad`` / ``photometric_optimize``: the legacy
  stereo paths, through the gradient of a warped right-to-left L1 + SSIM
  loss (reference: guidance.py:264-392).

The pipelines run under `torch.no_grad()`: the gradients here are taken
under `torch.enable_grad()` with `torch.autograd.grad` with respect to a
detached copy of the optimized tensor alone, and what they return carries
no graph. Where no path from that copy to the loss carries a gradient (a
decoder whose every path crosses a static int8 quantization: a fixed-scale
round, as in the JAX package, or a kernel's output), the gradient is zero
and the Adam steps leave the latent as it was.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from d3roma_tpu_torch.ops.losses import ssim
from d3roma_tpu_torch.ops.warp import warp_right_to_left

# optax.adam's defaults, and optax.sgd's momentum
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class FlowGuidance:
    """Guidance settings. The weight is an on/off gate, as in the
    reference: only `> 0` is ever read."""

    flow_guidance_weight: float = 1.0
    # carried for config parity; never read
    perturb_start_ratio: float = 0.0
    flow_guidance_mode: str = "imputation"  # "imputation" | "gradient"
    num_opt_steps: int = 10
    opt_lr: float = 1e-3

    @property
    def enabled(self) -> bool:
        return self.flow_guidance_weight > 0.0

    def make_latent_guidance_fn(self, decoder: Callable[[torch.Tensor], torch.Tensor],
                                denormer: Callable[[torch.Tensor], torch.Tensor],
                                raw_depth: torch.Tensor):
        """guidance_fn(pred_x0_latent, t) for the ODE steps, or None when
        disabled: `num_opt_steps` Adam steps at `opt_lr` on the latent, the
        loss the mean L1 between denormer(decoder(latent)) and raw_depth,
        both masked by raw_depth > 0 (reference: core/guidance.py:224-242,
        which recomputes the mask as raw_depth > 0, :227)."""
        if not self.enabled:
            return None
        if self.flow_guidance_mode != "gradient":
            raise NotImplementedError("latent diffusion does not support imputation mode")
        mask = (raw_depth > 0.0).to(raw_depth.dtype)

        def loss_fn(latent):
            pred = denormer(decoder(latent))
            return torch.mean(torch.abs(pred * mask - raw_depth * mask))

        def guidance_fn(pred_x0, t):
            return adam_minimize(loss_fn, pred_x0, self.num_opt_steps, self.opt_lr)

        return guidance_fn

    def make_pixel_imputation_fn(self, norm_raw_disp: torch.Tensor, raw_mask: torch.Tensor):
        """Pixel-space imputation: x_hat0 is replaced by the normalized raw
        disparity where the sensor saw something. None when disabled."""
        if not self.enabled:
            return None

        def guidance_fn(pred_x0, t):
            m = raw_mask.to(pred_x0.dtype)
            return pred_x0 * (1 - m) + norm_raw_disp * m

        return guidance_fn


def grad_of(loss_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """d loss_fn / d x at x, with nothing else differentiated and no graph
    kept; zeros where the loss does not depend on x through any
    differentiable path."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        loss = loss_fn(xi)
        g = None
        if loss.requires_grad:
            (g,) = torch.autograd.grad(loss, xi, allow_unused=True)
    return torch.zeros_like(x) if g is None else g.detach()


@contextlib.contextmanager
def frozen_parameters(module: torch.nn.Module):
    """`module`'s parameters out of autograd for the duration (forwards
    inside build no graph towards them), their flags restored after."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(True)


def _bias_correction(decay: float, count: int, like: torch.Tensor) -> torch.Tensor:
    """1 - decay**count in fp32, as a 0-d tensor of `like`'s dtype (a
    division by a tensor is IEEE on every device)."""
    bc = np.float32(1.0) - np.float32(decay) ** np.float32(count)
    return torch.tensor(float(bc), dtype=torch.float32, device=like.device).to(like.dtype)


def adam_minimize(loss_fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                  steps: int, lr: float) -> torch.Tensor:
    """`steps` updates of optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root, bias-corrected moments) from x0, freshly initialized;
    the result carries no graph."""
    x = x0.detach()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    for count in range(1, steps + 1):
        g = grad_of(loss_fn, x)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * g**2 + ADAM_B2 * nu
        mu_hat = mu / _bias_correction(ADAM_B1, count, mu)
        nu_hat = nu / _bias_correction(ADAM_B2, count, nu)
        x = x + mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) * (-lr)
    return x


def photometric_loss(disp: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                     ssim_weight: float = 0.95) -> torch.Tensor:
    """Sum of SSIM and L1 between the left image and the right image warped
    into the left view by `disp` (reference: core/guidance.py:298-322, with
    w = 0.95)."""
    warped = warp_right_to_left(right, disp)
    l1 = torch.sum(torch.abs(left - warped))
    s = torch.sum(ssim(left, warped))
    return ssim_weight * s + (1.0 - ssim_weight) * l1


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x**2))


def photometric_grad(norm_disp: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                     unnormalize: Callable[[torch.Tensor], torch.Tensor],
                     clip_norm: float = 1.0) -> torch.Tensor:
    """d(photometric loss) / d(normalized disparity), clipped to unit global
    norm (reference: core/guidance.py:264-334)."""
    g = grad_of(lambda nd: photometric_loss(unnormalize(nd), left, right), norm_disp)
    scale = torch.clamp(clip_norm / torch.clamp(_norm(g), min=1e-12), max=1.0)
    return g * scale


def photometric_optimize(norm_disp: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                         unnormalize: Callable[[torch.Tensor], torch.Tensor],
                         num_iters: int = 100, lr: float = 1e-2, momentum: float = 0.9,
                         alpha: float = 1e-4) -> torch.Tensor:
    """optax.sgd(lr, momentum) refinement of the disparity against the
    photometric loss (SSIM weight 0.85), each gradient clipped to the
    adaptive norm alpha * |x * grad_mask| / lr with grad_mask = |g| > 0: the
    reference's Langevin-like `optimize` (core/guidance.py:336-392). The
    momentum trace is t = g + momentum * t, the update -lr * t, without
    Nesterov."""
    def loss_of(nd):
        return photometric_loss(unnormalize(nd), left, right, ssim_weight=0.85)

    x = norm_disp.detach()
    trace = torch.zeros_like(x)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=x.device)
    for _ in range(num_iters):
        g = grad_of(loss_of, x)
        grad_mask = (torch.abs(g) > 0).to(x.dtype)
        max_norm = alpha * _norm(x * grad_mask) / lr_t
        g = g * torch.clamp(max_norm / torch.clamp(_norm(g), min=1e-12), max=1.0)
        trace = g + momentum * trace
        x = x + trace * (-lr)
    return x
