"""Affine-invariant multi-round depth ensembling (Marigold-style).

Port of `d3roma_tpu/ops/ensemble.py` (reference: utils_d3roma/utils.py:28-120):
align R predictions by per-image (scale, shift) minimizing their pairwise
RMS distance plus a [0, 1]-range regularizer, then reduce by median or
mean. 30 Adam steps on (s, t) with torch.autograd, as the JAX package runs
optax's Adam under jax.grad. Two definitions follow JAX, not PyTorch:

- the median of an even count is the mean of the two middle values
  (`jnp.median`, method "midpoint"), where `torch.median` returns the lower
  one; its gradient goes half to each of the two, through the sort;
- Adam is optax's: bias-corrected moments, eps outside the square root;
- |x| has JAX's derivative at 0, +1 (torch's is 0): the regularizer's
  |0 - min| is exactly 0 at the start, where every round is rescaled to
  [0, 1].
"""

from __future__ import annotations

from typing import Tuple

import torch


def _median0(x: torch.Tensor) -> torch.Tensor:
    """jnp.median(x, axis=0): (sorted[(n-1)//2] + sorted[n//2]) * 0.5."""
    s = torch.sort(x, dim=0, stable=True).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is +1, as jnp.abs's."""
    return torch.where(x >= 0, x, -x)


def _affine(images: torch.Tensor, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """images * s + t with one rounding, as XLA's fused multiply-add computes
    it in the jitted JAX function: the float32 product is exact in float64."""
    out = images.double() * s.double()[:, None, None] + t.double()[:, None, None]
    return out.float()


def _objective(s, t, images, regularizer_strength, reduction, iu):
    transformed = _affine(images, s, t)
    diffs = transformed[:, None] - transformed[None, :]
    sqrt_dist = torch.sqrt(torch.mean(diffs[iu[0], iu[1]] ** 2))
    pred = _median0(transformed) if reduction == "median" else torch.mean(transformed, dim=0)
    near_err = _abs(0.0 - torch.min(pred))
    far_err = _abs(1.0 - torch.max(pred))
    return sqrt_dist + (near_err + far_err) * regularizer_strength


def ensemble_depths(
    input_images: torch.Tensor,
    regularizer_strength: float = 0.02,
    reduction: str = "median",
    num_iters: int = 30,
    lr: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """input_images: [R, H, W] affine-invariant predictions.

    Returns (aligned [H,W] rescaled to [0,1], uncertainty [H,W]).
    """
    images = input_images.detach().float()
    n = images.shape[0]
    flat = images.reshape(n, -1)
    _min = torch.amin(flat, dim=1)
    _max = torch.amax(flat, dim=1)
    s0 = 1.0 / torch.clamp(_max - _min, min=1e-8)
    t0 = -s0 * _min
    if n == 1:
        # nothing to align: the pairwise objective is a mean over an
        # empty index set (NaN). Return the [0,1]-rescaled input with
        # zero uncertainty.
        aligned = images[0] * s0[0] + t0[0]
        return aligned, torch.zeros_like(aligned)

    iu = torch.triu_indices(n, n, offset=1, device=images.device)
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = [s0.clone(), t0.clone()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for count in range(1, num_iters + 1):
        s, t = (p.clone().requires_grad_(True) for p in params)
        with torch.enable_grad():
            loss = _objective(s, t, images, regularizer_strength, reduction, iu)
            grads = torch.autograd.grad(loss, (s, t))
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        for i, g in enumerate(grads):
            mu[i] = b1 * mu[i] + (1.0 - b1) * g
            nu[i] = b2 * nu[i] + (1.0 - b2) * g * g
            update = (mu[i] / c1.to(g.device)) / (torch.sqrt(nu[i] / c2.to(g.device)) + eps)
            params[i] = params[i] + update * -lr
    s, t = params

    transformed = _affine(images, s, t)
    if reduction == "mean":
        aligned = torch.mean(transformed, dim=0)
        uncertainty = torch.std(transformed, dim=0, unbiased=False)
    else:
        aligned = _median0(transformed)
        uncertainty = _median0(torch.abs(transformed - aligned))

    _mn = torch.min(aligned)
    _mx = torch.max(aligned)
    aligned = (aligned - _mn) / torch.clamp(_mx - _mn, min=1e-8)
    uncertainty = uncertainty / torch.clamp(_mx - _mn, min=1e-8)
    return aligned, uncertainty
