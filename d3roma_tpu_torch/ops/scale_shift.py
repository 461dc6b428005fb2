"""Closed-form and robust (RANSAC) scale/shift estimation.

Port of `d3roma_tpu/ops/scale_shift.py`: MiDaS-style least squares with an
identity fallback for degenerate systems, and the batched RANSAC over
(scale, shift). Where the JAX package draws each iteration's subset as
`jax.random.permutation(fold_in(key, i), N)[:n_sample]`, this RANSAC draws
it with `torch.randperm` from a `torch.Generator`, or takes the subsets as
an explicit [k_iters, n_sample] index tensor (a test passes the JAX
package's).
"""

from __future__ import annotations

from typing import Optional

import torch


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Least-squares (s, t) with target ~ s * prediction + t over mask.
    prediction/target/mask [B, N] -> [B, 2]. A system with det <= 1e-6 (an
    empty or near-constant mask) takes the identity (1, 0) — deliberately
    not the reference's 1e-4 nudge of every det, which can blow up the
    whole batch's solutions."""
    if mask is None:
        mask = torch.ones_like(target)
    mask = mask.to(prediction.dtype)
    pred = prediction * mask
    tgt = target * mask

    a_00 = torch.sum(mask * pred * pred, dim=1)
    a_01 = torch.sum(mask * pred, dim=1)
    a_11 = torch.sum(mask, dim=1)
    b_0 = torch.sum(mask * pred * tgt, dim=1)
    b_1 = torch.sum(mask * tgt, dim=1)

    det = a_00 * a_11 - a_01 * a_01
    valid = det > 1e-6
    safe_det = torch.where(valid, det, torch.ones_like(det))
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, torch.ones_like(det))
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, torch.zeros_like(det))
    return torch.stack([x_0, x_1], dim=1)


def _accuracy_inverse(y_true: torch.Tensor, y_pred: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """1 / (delta < 1.25 accuracy) over the masked pixels, [B]."""
    tiny = torch.full((), 1e-8, dtype=y_pred.dtype, device=y_pred.device)
    safe_pred = torch.where(y_pred == 0, tiny, y_pred)
    safe_true = torch.where(y_true == 0, tiny, y_true)
    thresh = torch.maximum(safe_true / safe_pred, safe_pred / safe_true)
    ok = ((thresh < 1.25) & (mask > 0)).to(torch.float32)
    denom = torch.sum(mask, dim=1).clamp(min=1.0)
    acc = torch.sum(ok, dim=1) / denom
    return 1.0 / acc.clamp(min=1e-8)


def ransac_sizes(n: int, n_frac: float = 0.1, d_frac: float = 0.2):
    """(subset size, inlier count to beat) of a RANSAC over n points."""
    return max(1, int(n_frac * n)), int(d_frac * n)


def ransac_scale_shift(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_frac: float = 0.1,
    k_iters: int = 10,
    d_frac: float = 0.2,
    error_threshold: float = 0.6,
    subsets: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched RANSAC over (scale, shift). pred/target/mask [B, N] -> [B, 2].

    Per iteration: fit on a subset of int(n_frac * N) points shared by the
    batch, take the inliers (squared error < threshold, inside the mask),
    refit on them, and keep the refit where it has more than int(d_frac * N)
    inliers and a lower inverse accuracy than the best so far (else the
    identity stays). `subsets` [k_iters, n_sample] replaces the generator's
    draws."""
    B, N = pred.shape
    n_sample, d_min = ransac_sizes(N, n_frac, d_frac)
    if subsets is not None:
        subsets = torch.as_tensor(subsets).to(pred.device, torch.long)
        if tuple(subsets.shape) != (k_iters, n_sample):
            raise ValueError(f"subsets {tuple(subsets.shape)} != ({k_iters}, {n_sample})")
    elif generator is None:
        raise ValueError("ransac_scale_shift needs a torch.Generator or explicit subsets")
    maskf = mask.to(pred.dtype)

    kw = dict(dtype=pred.dtype, device=pred.device)
    best_fit = torch.cat([torch.ones((B, 1), **kw), torch.zeros((B, 1), **kw)], dim=1)
    best_error = torch.full((B,), float("inf"), dtype=pred.dtype, device=pred.device)
    for i in range(k_iters):
        if subsets is not None:
            idx = subsets[i]
        else:
            idx = torch.randperm(N, generator=generator, device=generator.device)[:n_sample]
            idx = idx.to(pred.device)
        maybe = compute_scale_and_shift(pred[:, idx], target[:, idx], maskf[:, idx])
        fitted = pred * maybe[:, 0:1] + maybe[:, 1:2]
        inlier = (((target - fitted) ** 2) < error_threshold) & (mask > 0)
        inlier_f = inlier.to(pred.dtype)

        better = compute_scale_and_shift(pred, target, inlier_f)
        refit = pred * better[:, 0:1] + better[:, 1:2]
        this_error = _accuracy_inverse(target, refit, inlier_f)
        this_num = torch.sum(inlier, dim=1)

        select = (this_num > d_min) & (this_error < best_error)
        best_fit = torch.where(select[:, None], better, best_fit)
        best_error = torch.where(select, this_error, best_error)
    return best_fit
