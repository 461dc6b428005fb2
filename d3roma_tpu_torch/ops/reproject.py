"""Depth reprojection between camera frames, on tensors.

Port of `d3roma_tpu/ops/reproject.py`, the device-side counterpart of
`DepthCamera._reproject` (the numpy scatter of the host streaming path;
reference: utils_d3roma/camera.py:654-701): backproject depth through
K_src, transform by T, project through K_dst, and scatter into the target
frame with the reference's aggressive 4-corner fill. The scatter is a
z-buffer (`scatter_reduce_(..., "amin")`, the JAX package's `.at[].min`),
so where several sources land on one target pixel the nearest surface
wins. The matrices are fp32 and multiplied as plain fp32 products (the
card's TF32 matmul setting is off by default and nothing here turns it on).
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = 1e10


@torch.no_grad()
def reproject_depth(
    depth: torch.Tensor,
    K_src: torch.Tensor,
    K_dst: torch.Tensor,
    T: torch.Tensor,
    out_hw: Tuple[int, int],
    aggressive_fill: bool = True,
) -> torch.Tensor:
    """depth [H, W] in the source camera frame -> depth [oH, oW] in the
    destination frame; 0 marks holes. The matrices are moved to depth's
    device."""
    H, W = depth.shape
    oH, oW = out_hw
    dev = depth.device
    f32 = dict(dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(H * W, **f32)])
    d = depth.reshape(-1).to(torch.float32)
    K_src, K_dst, T = (torch.as_tensor(m).to(**f32) for m in (K_src, K_dst, T))
    pts = torch.linalg.inv(K_src) @ pix * d[None, :]
    pts = T[:3, :3] @ pts + T[:3, 3:]
    # destination-frame z is what gets scattered AND what wins the z-buffer
    z_dst = pts[2]
    valid = (d > 0.0) & (z_dst > 0.0)  # behind-camera points drop out
    proj = K_dst @ pts
    u = proj[0] / torch.clamp(proj[2], min=1e-12)
    v = proj[1] / torch.clamp(proj[2], min=1e-12)

    zbuf = torch.full((oH * oW,), _INF, **f32)
    inf = torch.full_like(z_dst, _INF)

    def scatter(uu, vv):
        uu = torch.round(uu).to(torch.int64)
        vv = torch.round(vv).to(torch.int64)
        ok = valid & (uu >= 0) & (uu < oW) & (vv >= 0) & (vv < oH)
        # out-of-bounds / invalid samples write +inf at a clamped index
        val = torch.where(ok, z_dst, inf)
        idx = torch.clamp(vv, 0, oH - 1) * oW + torch.clamp(uu, 0, oW - 1)
        zbuf.scatter_reduce_(0, idx, val, reduce="amin", include_self=True)

    if aggressive_fill:
        for fu in (torch.floor, torch.ceil):
            for fv in (torch.floor, torch.ceil):
                scatter(fu(u), fv(v))
    else:
        scatter(u, v)
    zbuf = zbuf.reshape(oH, oW)
    return torch.where(zbuf >= _INF, torch.zeros_like(zbuf), zbuf)
