"""Test-time flow guidance.

Port of `d3roma_tpu/guidance.py`: the `FlowGuidance` configuration (the
fields the JAX package saves with a pipeline) and the pixel-space
imputation hook. The latent gradient mode (an inner Adam loop through the
VAE decoder) and the photometric stereo modes are not ported yet: asking
for them raises.
"""

from __future__ import annotations

import dataclasses

import torch


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

    def make_latent_guidance_fn(self, decoder, denormer, raw_depth):
        """The latent gradient guidance (Adam on x_hat0 through the VAE
        decoder): not ported yet."""
        if not self.enabled:
            return None
        raise NotImplementedError("latent gradient guidance is not ported yet")

    def make_pixel_imputation_fn(self, norm_raw_disp: torch.Tensor, raw_mask: torch.Tensor):
        """Pixel-space imputation: x_hat0 is replaced by the normalized raw
        disparity where the sensor saw something. None when disabled."""
        if not self.enabled:
            return None

        def guidance_fn(pred_x0, t):
            m = raw_mask.to(pred_x0.dtype)
            return pred_x0 * (1 - m) + norm_raw_disp * m

        return guidance_fn
