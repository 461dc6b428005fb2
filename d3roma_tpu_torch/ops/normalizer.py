"""Disparity normalization to the diffusion working range [-1, 1].

Port of the non-SSI `Normalizer` of `d3roma_tpu/ops/normalizer.py` (the
`average` and `piecewise` modes), channel-last like the reference. The SSI
mode (per-sample quantiles, LSQ/RANSAC re-alignment) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Normalizer:
    ssi: bool = False
    mode: str = "piecewise"  # "piecewise" | "average"
    num_chs: int = 3
    ch_bounds: Tuple[float, ...] = (64.0, 32.0, 32.0)
    ch_gammas: Tuple[float, ...] = (1.0, 1.0, 1.0)
    t: float = 0.5
    s: float = 2.0

    def __post_init__(self):
        if self.ssi:
            raise NotImplementedError(
                "the SSI normalizer (quantile scale/shift, RANSAC "
                "re-alignment) is not ported yet")
        if self.mode not in ("average", "piecewise"):
            raise ValueError(f"unknown normalize mode: {self.mode!r}")

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """Disparity [..., H, W, 1] -> [..., H, W, num_chs] in [-1, 1]."""
        return (self._encode(x) - self.t) * self.s

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        x = x.clamp(max=float(sum(self.ch_bounds[: max(1, self.num_chs)])))
        if self.mode == "average":
            ch = (x / self.ch_bounds[0]) ** self.ch_gammas[0]
            return torch.cat([ch] * self.num_chs, dim=-1)
        chs = []
        residual = x
        for bound, gamma in zip(self.ch_bounds[: self.num_chs],
                                self.ch_gammas[: self.num_chs]):
            ch = residual.clamp(max=bound) / bound
            residual = torch.where(ch < 1.0, torch.zeros_like(residual), residual - bound)
            chs.append(ch**gamma)
        return torch.cat(chs, dim=-1)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> disparity [B, H, W, C // num_chs]."""
        B, H, W, C = y.shape
        R = C // self.num_chs
        z = self._decode(y.reshape(B, H, W, R, self.num_chs) / self.s + self.t)
        return z.reshape(B, H, W, R)

    def _decode(self, y: torch.Tensor) -> torch.Tensor:
        if self.mode == "average":
            return ((y ** (1.0 / self.ch_gammas[0])).sum(dim=-1)
                    * (self.ch_bounds[0] / self.num_chs))
        z = 0.0
        for i in range(self.num_chs):
            z = z + y[..., i] ** (1.0 / self.ch_gammas[i]) * self.ch_bounds[i]
        return z
