"""Disparity / depth quality metrics with fixed-shape masked reductions.

Port of `d3roma_tpu/ops/metrics.py` on torch tensors. Semantics follow the
reference's `compute_errors` (reference: utils_d3roma/utils.py:554-661):
per-sample disparity EPE and D1/D2/D3/D5 threshold rates scaled by
width/480, plus depth delta-accuracy at 1.05/1.10/1.25, RMSE, AbsRel and
MAE, as masked means (no data-dependent shapes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DISP_KEYS = ("epe", "d1", "d2", "d3", "d5")
DEPTH_KEYS = ("a1", "a2", "a3", "rmse", "rel", "mae")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, axis) -> torch.Tensor:
    denom = torch.clamp(torch.sum(mask, dim=axis), min=1.0)
    return torch.sum(x * mask, dim=axis) / denom


def _masked_min(x: torch.Tensor, mask: torch.Tensor, axis) -> torch.Tensor:
    return torch.amin(torch.where(mask > 0, x, torch.full_like(x, float("inf"))), dim=axis)


def compute_errors(
    gt: torch.Tensor,
    pred: torch.Tensor,
    space: str = "disp",
    masks: Optional[torch.Tensor] = None,
    fxb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """gt/pred: [B, H, W] in `space` ("disp" or "depth"); masks: [B, H, W]
    booleans; fxb: [B] focal*baseline for disp<->depth conversion.

    Returns (metrics_disp [B,5], metrics_depth [B,6]) matching the reference
    column order: [epe, d1, d2, d3, d5] and [a1, a2, a3, rmse, rel, mae].
    """
    if gt.ndim != 3 or pred.ndim != 3:
        raise ValueError("expected B,H,W")
    B, H, W = gt.shape
    gt = gt.float()
    pred = pred.float()
    if masks is None:
        masks = ~(torch.isnan(gt) | torch.isinf(gt) | (gt == 0))
    masks = masks.to(torch.bool)
    m = masks.reshape(B, -1).to(torch.float32)
    gt = gt.reshape(B, -1)
    zero = torch.zeros((), dtype=torch.float32, device=gt.device)
    one = torch.ones((), dtype=torch.float32, device=gt.device)
    pred = torch.where(masks, pred, zero).reshape(B, -1)

    if space == "depth":
        # clip non-positive predicted depth (reference: utils.py:583-586)
        pred_depth = torch.clamp(pred, min=1e-3)
        gt_depth = torch.where(m > 0, gt, one)
        # disparity metrics need a focal-baseline; pseudo fxb=1 (1/depth
        # disparities) keeps depth-space metrics meaningful when a
        # dataset carries no fxb, matching the disp branch's None path
        fxb_d = torch.ones((B,), device=gt.device) if fxb is None else fxb.float()
        gt_disp = fxb_d[:, None] / gt_depth
        pred_disp = fxb_d[:, None] / pred_depth
    elif space == "disp":
        # when any masked prediction is non-positive, clip the whole sample's
        # predictions up to the masked gt minimum (reference: utils.py:596-601)
        min_disp = _masked_min(gt, m, axis=1)[:, None]
        has_bad = (_masked_min(pred, m, axis=1) <= 0)[:, None]
        pred_disp = torch.where(has_bad, torch.maximum(pred, min_disp), pred)
        gt_disp = torch.where(m > 0, gt, one)
        if fxb is not None:
            gt_depth = fxb.float()[:, None] / gt_disp
            pred_depth = fxb.float()[:, None] / torch.clamp(pred_disp, min=1e-8)
        else:
            gt_depth = 1.0 / gt_disp
            pred_depth = 1.0 / torch.clamp(pred_disp, min=1e-8)
    else:
        raise NotImplementedError(space)

    # disparity metrics
    epe_err = torch.abs(gt_disp - pred_disp)
    epe = _masked_mean(epe_err, m, axis=1)
    # D-threshold scale: DELIBERATE divergence from the reference. The
    # reference computes scale = masked_pixel_count/480 (utils.py:626-630,
    # its own FIXME admits the bug); the intended semantics is the
    # image-width ratio W/480, used here. D1/D2/D3/D5 numbers are therefore
    # NOT directly comparable with reference-produced logs (see
    # docs/PARITY.md).
    scale = W / 480.0
    rates = [
        _masked_mean((epe_err > k * scale).to(torch.float32), m, axis=1)
        for k in (1.0, 2.0, 3.0, 5.0)
    ]
    metrics_disp = torch.stack([epe] + rates, dim=1)

    # depth metrics
    safe_pred = torch.where(m > 0, pred_depth, one)
    safe_gt = torch.where(m > 0, gt_depth, one)
    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = _masked_mean((thresh < 1.05).to(torch.float32), m, axis=1)
    a2 = _masked_mean((thresh < 1.10).to(torch.float32), m, axis=1)
    a3 = _masked_mean((thresh < 1.25).to(torch.float32), m, axis=1)
    rmse = torch.sqrt(_masked_mean((safe_gt - safe_pred) ** 2, m, axis=1))
    rel = _masked_mean(torch.abs(safe_gt - safe_pred) / safe_gt, m, axis=1)
    mae = _masked_mean(torch.abs(safe_gt - safe_pred), m, axis=1)
    metrics_depth = torch.stack([a1, a2, a3, rmse, rel, mae], dim=1)

    return metrics_disp, metrics_depth


def metrics_to_dict(metrics_disp, metrics_depth):
    """Reference: utils_d3roma/utils.py:657-661."""
    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    md = host(metrics_disp).reshape(-1, 5).mean(0)
    me = host(metrics_depth).reshape(-1, 6).mean(0)
    return {
        "disp": dict(zip(DISP_KEYS, md.tolist())),
        "depth": dict(zip(DEPTH_KEYS, me.tolist())),
    }
