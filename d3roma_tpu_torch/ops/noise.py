"""Noise for the forward process, and the train step's random draws.

Port of `d3roma_tpu/ops/noise.py`. `pyramid_noise_like` is the static dyadic
pyramid of the JAX package (a base draw plus up to 10 coarser levels, each
upsampled bilinearly with half-pixel centres and added with weight 0.9^i),
normalised by the population standard deviation, as `jnp.std` computes it.

Every random draw of a train step goes through one object, `draws`, in the
order the JAX step splits its key (the noise, then the timesteps, then the
RGB condition's noise). `GeneratorDraws` takes them from one
`torch.Generator` on the step's device; a test passes an object with the
same three methods that replays the JAX package's draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class GeneratorDraws:
    """A train step's draws from `generator`, on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device, dtype=dtype)

    def randint(self, low: int, high: int, n: int) -> torch.Tensor:
        return torch.randint(low, high, (n,), generator=self.generator,
                             device=self.generator.device)

    def categorical(self, probs: torch.Tensor, n: int) -> torch.Tensor:
        """n indices drawn with replacement, index i with probability probs[i]."""
        return torch.multinomial(probs, n, replacement=True, generator=self.generator)


def pyramid_noise_like(draws, shape, dtype=torch.float32, discount: float = 0.9) -> torch.Tensor:
    """Multiscale noise, NHWC shape [B, H, W, C], normalized to unit std."""
    b, h, w, c = shape
    noise = draws.normal((b, h, w, c), dtype)
    for i in range(1, 11):
        hh, ww = max(1, h // (2**i)), max(1, w // (2**i))
        level = draws.normal((b, hh, ww, c), dtype)
        up = F.interpolate(level.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
        noise = noise + up * (discount**i)
        if hh == 1 or ww == 1:
            break
    return noise / torch.std(noise, correction=0)


def make_noise(draws, shape, strategy: str = "randn", dtype=torch.float32) -> torch.Tensor:
    """Dispatch on `config.noise_strategy`."""
    if strategy == "pyramid":
        return pyramid_noise_like(draws, shape, dtype)
    if strategy == "randn":
        return draws.normal(shape, dtype)
    raise ValueError(f"unknown noise strategy: {strategy!r}")
