"""Differentiable bilinear warping for stereo, NHWC.

Port of `d3roma_tpu/ops/warp.py` (reference: core/guidance.py:264-334,
scripts/stereo_matching.py:183-202): the floor-and-gather form with zero
padding outside the image. Not `F.grid_sample`, whose gradient at integer
coordinates and at the border differs from the gather form's: the
photometric guidance's gradient is the JAX package's.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img [B, H, W, C] at continuous pixel coordinates x, y [B, H,
    W] (grid_sample's align_corners=True pixel convention, zero padding)."""
    B, H, W, _ = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    bidx = torch.arange(B, device=img.device)[:, None, None]

    def gather(ix, iy):
        valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        return img[bidx, iyc, ixc] * valid[..., None].to(img.dtype)

    return (gather(x0, y0) * (wx0 * wy0)[..., None]
            + gather(x1, y0) * (wx1 * wy0)[..., None]
            + gather(x0, y1) * (wx0 * wy1)[..., None]
            + gather(x1, y1) * (wx1 * wy1)[..., None])


def warp_right_to_left(right: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    """The right image [B, H, W, C] warped into the left view by the
    left-frame disparity [B, H, W] (positive shifts leftward; reference:
    core/guidance.py:308-318)."""
    B, H, W, _ = right.shape
    xs = torch.arange(W, dtype=disparity.dtype, device=disparity.device)[None, None, :]
    ys = torch.arange(H, dtype=disparity.dtype, device=disparity.device)[None, :, None]
    return bilinear_sample(right, xs.expand(B, H, W) - disparity, ys.expand(B, H, W))
