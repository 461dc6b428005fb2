"""Disparity normalization to the diffusion working range [-1, 1].

Port of `d3roma_tpu/ops/normalizer.py`, channel-last like the reference, in
its three regimes:

- ``average``:   y = ((x / bound) ** gamma - t) * s, replicated over
  ``num_chs`` channels; denormalize sums the per-channel inverses;
- ``piecewise``: a bounded residual decomposition into up to 3 channels;
- ``ssi``:       per-sample quantile window to [0, 1], then (y - t) * s;
  denormalize re-aligns each round against the raw disparity by least
  squares, or by RANSAC under `safe_ssi`.

`normalize` returns (y, low, up) in every regime (None, None outside SSI),
as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from d3roma_tpu_torch.ops.scale_shift import compute_scale_and_shift, ransac_scale_shift


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """Quantiles of each row of x [B, N] over its masked entries, [len(qs),
    B]: jnp.nanquantile's linear interpolation (position q * (n - 1) among
    the n masked values). A row without a masked value gives NaN. By one
    sort per row, so that no input size limit applies (torch.quantile
    refuses more than 2^24 elements)."""
    vals = torch.where(mask, x, torch.full_like(x, float("nan")))
    ordered = torch.sort(vals, dim=1).values  # NaN sorts last
    n = mask.sum(dim=1).to(x.dtype)
    last = (n - 1.0).clamp(min=0.0)
    out = []
    for q in qs:
        pos = q * (n - 1.0)
        low, high = torch.floor(pos), torch.ceil(pos)
        w_high = pos - low
        low = torch.minimum(low.clamp(min=0.0), last).long()
        high = torch.minimum(high.clamp(min=0.0), last).long()
        v_low = ordered.gather(1, low[:, None])[:, 0]
        v_high = ordered.gather(1, high[:, None])[:, 0]
        out.append(v_low * (1.0 - w_high) + v_high * w_high)
    return torch.stack(out)


@dataclasses.dataclass(frozen=True)
class Normalizer:
    ssi: bool = False
    mode: str = "piecewise"  # "piecewise" | "average"
    num_chs: int = 3
    ch_bounds: Tuple[float, ...] = (64.0, 32.0, 32.0)
    ch_gammas: Tuple[float, ...] = (1.0, 1.0, 1.0)
    t: float = 0.5
    s: float = 2.0
    safe_ssi: bool = True
    ransac_error_threshold: float = 0.6
    low_p: float = 0.0
    high_p: float = 1.0

    def __post_init__(self):
        if self.mode not in ("average", "piecewise"):
            raise ValueError(f"unknown normalize mode: {self.mode!r}")

    @staticmethod
    def from_config(config) -> "Normalizer":
        """From any object with the training config's attributes (ssi,
        normalize_mode, num_chs, ch_bounds, ch_gammas, norm_t, norm_s,
        safe_ssi, ransac_error_threshold, optionally ssi_low_p and
        ssi_high_p)."""
        return Normalizer(
            ssi=config.ssi, mode=config.normalize_mode, num_chs=config.num_chs,
            ch_bounds=tuple(config.ch_bounds), ch_gammas=tuple(config.ch_gammas),
            t=config.norm_t, s=config.norm_s, safe_ssi=config.safe_ssi,
            low_p=getattr(config, "ssi_low_p", 0.0),
            high_p=getattr(config, "ssi_high_p", 1.0),
            ransac_error_threshold=config.ransac_error_threshold)

    def normalize(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  low: Optional[torch.Tensor] = None, up: Optional[torch.Tensor] = None):
        """Disparity [..., H, W, 1] -> (y [..., H, W, num_chs or 1], low, up).
        SSI: low/up are the per-sample low_p/high_p quantiles over the mask
        ([B, 1, 1, 1] for a batch, 0-d for one frame) unless given; an
        all-invalid frame or a constant window takes (0, 1); y is 0 outside
        the mask."""
        if not self.ssi:
            return (self._encode(x) - self.t) * self.s, None, None
        mask = torch.ones_like(x, dtype=torch.bool) if mask is None else mask.to(torch.bool)
        if low is None or up is None:
            if x.ndim == 4:
                q = masked_quantile(x.reshape(x.shape[0], -1), mask.reshape(x.shape[0], -1),
                                    [self.low_p, self.high_p])
                low, up = q[0].reshape(-1, 1, 1, 1), q[1].reshape(-1, 1, 1, 1)
            else:
                q = masked_quantile(x.reshape(1, -1), mask.reshape(1, -1),
                                    [self.low_p, self.high_p])
                low, up = q[0, 0], q[1, 0]
        bad = ~torch.isfinite(low) | ~torch.isfinite(up) | (up - low <= 0)
        low = torch.where(bad, torch.zeros_like(low), low)
        up = torch.where(bad, torch.ones_like(up), up)
        y = (torch.clamp((x - low) / (up - low), 0.0, 1.0) - self.t) * self.s
        return torch.where(mask, y, torch.zeros_like(y)), low, up

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

    def denormalize(self, y: torch.Tensor, raw_disp: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    subsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, H, W, C] -> disparity [B, H, W, R]. SSI: each of the R
        channel-stacked rounds is aligned to raw_disp [B, H, W, 1] over mask
        by least squares, or under `safe_ssi` by RANSAC with subsets from
        `generator` or the explicit `subsets` [10, int(0.1 * H * W)]."""
        if self.ssi:
            if raw_disp is None or mask is None:
                raise ValueError("SSI denormalize needs raw_disp and mask")
            B, H, W, R = y.shape
            pred = y.movedim(-1, 1).reshape(B * R, H * W)
            gt = raw_disp.movedim(-1, 1).expand(B, R, H, W).reshape(B * R, H * W)
            m = mask.to(y.dtype).movedim(-1, 1).expand(B, R, H, W).reshape(B * R, H * W)
            if self.safe_ssi:
                st = ransac_scale_shift(pred, gt, m, generator, n_frac=0.1, k_iters=10,
                                        d_frac=0.2, error_threshold=self.ransac_error_threshold,
                                        subsets=subsets)
            else:
                st = compute_scale_and_shift(pred, gt, m)
            return y * st[:, 0].reshape(B, 1, 1, R) + st[:, 1].reshape(B, 1, 1, R)
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


def normalize_rgb(*images):
    """uint8-range [0, 255] images -> [-1, 1] (None stays None)."""
    return [None if im is None else (im / 255.0 - 0.5) * 2.0 for im in images]
