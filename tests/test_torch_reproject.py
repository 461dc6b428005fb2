"""The port's depth reprojection (d3roma_tpu_torch/ops/reproject.py) against
the JAX package's `reproject_depth` on the CPU: the RealSense fxm camera at
64x36, depth in 0.5-2.0 m with 20% holes, depth-to-color (the camera's
T_cl), with and without the 4-corner fill, and a rotated transform with
points that leave the frame.

Tolerance: the same holes exactly, the depths within DEPTH_RTOL (fp32; the
inverse and the products in another order move u, v by a last place, which
rounds to the same pixel but for ties), on at least HOLE_AGREE of the
pixels where a rounding tie lands a point one pixel over (measured: bit-equal
in all four cases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.reproject import reproject_depth as jax_reproject
from d3roma_tpu_torch.ops.reproject import reproject_depth
from d3roma_tpu_torch.utils.camera import Realsense

DEPTH_RTOL = 1e-5
HOLE_AGREE = 0.999


def _case(rotate):
    cam = Realsense.default_real("fxm")
    cam.change_resolution("64x36")
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 2.0, (36, 64)).astype(np.float32)
    depth[rng.random((36, 64)) < 0.2] = 0.0  # holes
    T = np.array(cam.T_cl, np.float32)
    if rotate:  # 0.2 rad about y and a shift: some points leave the frame
        c, s = np.cos(0.2), np.sin(0.2)
        T = T.copy()
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ T[:3, :3]
        T[0, 3] += 0.1
    return depth, np.asarray(cam.K_depth.arr, np.float32), np.asarray(cam.K_color.arr,
                                                                       np.float32), T


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("fill", [True, False])
def test_reproject_matches_jax(rotate, fill):
    depth, K_src, K_dst, T = _case(rotate)
    want = np.asarray(jax_reproject(jnp.asarray(depth), jnp.asarray(K_src), jnp.asarray(K_dst),
                                    jnp.asarray(T), (36, 64), aggressive_fill=fill))
    got = reproject_depth(torch.from_numpy(depth), torch.from_numpy(K_src),
                          torch.from_numpy(K_dst), torch.from_numpy(T), (36, 64),
                          aggressive_fill=fill).numpy()
    assert got.shape == (36, 64) and got.dtype == np.float32
    assert 0.3 < (want > 0).mean() < 1.0
    same = (got > 0) == (want > 0)
    assert same.mean() >= HOLE_AGREE
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= DEPTH_RTOL * want[both]
    assert close.mean() >= HOLE_AGREE
    # z-buffer: every filled value is a reprojected source surface's z
    assert np.isfinite(got).all() and (got >= 0).all()
