"""The host plan of the CUDA fused GroupNorm + SiLU (one launch on thread
block clusters; ops/kernels/groupnorm.py::gn_plan) and a plain-torch model
of the kernel's order of reduction (csrc/groupnorm_silu.cu), on the CPU:
each CTA's per-channel sums of x and x^2 (thread rows walking every rows-th
pixel, then the rows by a pairwise tree), its fold of each group's channels
in order, and the cluster's rank-ordered sum of the CTAs' group partials. The model is
held against the JAX Pallas kernel in interpret mode and against the port's
plain version; the plan is checked at the opt-in path's sites and at the
gate's 4 MiB edge."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import groupnorm as jax_gn
from d3roma_tpu_torch.ops.kernels import groupnorm as pg
from d3roma_tpu_torch.ops.kernels.quantize import fp32
from torch_port_utils import randn

# the tolerance the port states for the fused GroupNorm: 1e-2 x max |ref|
REL_TOL = 1e-2
# the model against the plain version, fp32: the same sums in another order
FP32_TOL = 1e-5
SMS = 132


def _cluster_model(x, gamma, beta, groups, eps, silu, plan):
    """The kernel's arithmetic in its order, fp32, for x [B, H, W, C] (the
    SiLU exactly, where the kernel takes the hardware's exp2 and division
    approximations)."""
    b, h, w, c = x.shape
    p, cg = h * w, c // groups
    xf = x.float().reshape(b, p, c)
    rows = pg.gn_rows(plan.band)
    inv_n, eps32 = fp32(1.0 / (p * cg)), fp32(eps)
    out = torch.empty_like(xf)
    for bi in range(b):
        for band in range(plan.bands):
            cols = slice(band * plan.band, (band + 1) * plan.band)
            parts = []
            for rank in range(plan.cluster):
                tile = xf[bi, rank * plan.per:min((rank + 1) * plan.per, p), cols]
                steps = -(-tile.shape[0] // rows)
                # thread row r takes pixels r, r + rows, ...: zeros past the
                # tile add nothing
                walk = torch.zeros((steps * rows, plan.band))
                walk[:tile.shape[0]] = tile
                walk = walk.reshape(steps, rows, plan.band)
                s = torch.zeros((rows, plan.band))
                q = torch.zeros((rows, plan.band))
                for st in range(steps):
                    s = s + walk[st]
                    q = q + walk[st] * walk[st]
                # the rows by a pairwise tree: row r += row r + ceil(n / 2)
                red = torch.stack([s, q], dim=1)  # [rows, 2, band]
                n = rows
                while n > 1:
                    h = (n + 1) // 2
                    red[:n - h] = red[:n - h] + red[h:n]
                    n = h
                csum = red[0]
                part = torch.zeros((2, plan.k))
                for j in range(cg):
                    part = part + csum[:, j::cg][:, :plan.k]
                parts.append(part)
            total = torch.zeros((2, plan.k))
            for part in parts:  # every CTA adds the ranks' partials in rank order
                total = total + part
            mean = total[0] * inv_n
            var = total[1] * inv_n - mean * mean
            inv = torch.rsqrt(var + eps32).repeat_interleave(cg)
            g = gamma[cols].float()
            scale = inv * g
            shift = beta[cols].float() - mean.repeat_interleave(cg) * scale
            y = xf[bi, :, cols] * scale + shift
            if silu:
                y = y * (1.0 / (1.0 + torch.exp(-y)))
            out[bi, :, cols] = y
    return out.reshape(x.shape).to(x.dtype)


def _inputs(shape, seed=0):
    c = shape[-1]
    return (randn(seed, *shape) * 2.0 + 0.5, 1.0 + 0.1 * randn(seed + 1, c),
            0.1 * randn(seed + 2, c))


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 6, 10, 96), 32, True),   # C / G = 3: bands of 8 groups
    ((1, 5, 7, 64), 8, True),     # odd H and W, 8 channels a group
    ((2, 4, 6, 40), 4, False),    # C / G = 10: one band of all 4 groups; the GroupNorm alone
])
def test_cluster_model_matches_pallas_kernel(shape, groups, silu):
    x, gamma, beta = _inputs(shape)
    ref = np.asarray(jax_gn.fused_group_norm_silu(jnp.asarray(x), jnp.asarray(gamma),
                                                  jnp.asarray(beta), groups, 1e-5, silu,
                                                  interpret=True))
    b, h, w, c = shape
    plan = pg.gn_plan(b, h * w, c, groups, 4, SMS)
    assert plan.band % 8 == 0 and plan.band == plan.k * (c // groups)
    xt, gt, bt = (torch.from_numpy(a) for a in (x, gamma, beta))
    plain = pg.group_norm_silu_plain(xt, gt, bt, groups, 1e-5, silu).numpy()
    tol = REL_TOL * np.abs(ref).max()
    # the plan's clusters, and the same band as one CTA and as a cluster of 3
    for p in (plan, dataclasses.replace(plan, cluster=1, per=h * w),
              dataclasses.replace(plan, cluster=3, per=-(-h * w // 3))):
        out = _cluster_model(xt, gt, bt, groups, 1e-5, silu, p).numpy()
        assert np.abs(out - ref).max() <= tol, (p, np.abs(out - ref).max())
        np.testing.assert_allclose(out, plain, atol=FP32_TOL, rtol=FP32_TOL)


# the opt-in path's fused sites (chip_smoke's routing dry pass at batch 2,
# the VAE encode at 4) and the gate's 4 MiB edge, bf16 and fp32
OPT_IN_SITES = [(2, 12, 20, c) for c in (640, 1280, 1920, 2560)] + \
    [(2, 23, 40, c) for c in (320, 640, 960, 1280, 1920)] + \
    [(2, 45, 80, 320), (2, 45, 80, 512), (2, 6, 10, 1280), (2, 6, 10, 2560), (4, 45, 80, 512)]
GATE_EDGE = [((1, 64, 64, 512), 2), ((1, 64, 64, 256), 4), ((1, 32, 128, 512), 2),
             ((2, 32, 32, 1024), 2)]


def _check_plan(b, p, c, groups, itemsize):
    plan = pg.gn_plan(b, p, c, groups, itemsize, SMS)
    cg = c // groups
    assert plan.band == plan.k * cg and plan.band % 8 == 0      # 16-byte aligned pixel rows
    assert groups % plan.k == 0 and plan.bands == groups // plan.k  # whole groups a band
    assert plan.cluster in pg.CLUSTER_SIZES
    assert plan.per * plan.cluster >= p > plan.per * (plan.cluster - 1)  # no empty CTA
    assert plan.smem_bytes == pg.gn_smem_bytes(plan.per, plan.band, plan.k, itemsize,
                                               plan.resident)
    assert plan.smem_bytes <= pg.MAX_SMEM_BYTES == 227 * 1024
    assert plan.ctas == b * plan.bands * plan.cluster
    return plan


def _one_wave(plan):
    """The CTAs fill at least most of the 132 SMs, one CTA an SM."""
    return 0.75 * SMS <= plan.ctas <= SMS


@pytest.mark.parametrize("shape", OPT_IN_SITES)
def test_plan_at_the_opt_in_sites(shape):
    """x is read from HBM once (the tile stays resident), in portable
    clusters, and the CTAs fill most of the H100's 132 SMs, one an SM."""
    b, h, w, c = shape
    plan = _check_plan(b, h * w, c, 32, 2)
    assert plan.resident and plan.cluster <= pg.MAX_PORTABLE_CLUSTER
    assert _one_wave(plan), plan


@pytest.mark.parametrize("shape,itemsize", GATE_EDGE)
def test_plan_at_the_gate_edge(shape, itemsize):
    b, h, w, c = shape
    assert h * w * c * itemsize <= 4 * 1024 * 1024
    plan = _check_plan(b, h * w, c, 32, itemsize)
    assert plan.resident and plan.cluster <= pg.MAX_PORTABLE_CLUSTER
    assert _one_wave(plan), plan


def test_plan_in_one_group():
    """One group: a 2 MiB band fits 16 CTAs but not 8, so the plan takes the
    non-portable cluster of 16; a 4 MiB band fits no cluster, so the plan
    reads x a second time (from L2) in the same launch, in a cluster of 8."""
    two = _check_plan(1, 32 * 64, 512, 1, 2)
    assert (two.cluster, two.resident) == (16, True)
    assert pg.gn_smem_bytes(-(-32 * 64 // 8), 512, 1, 2, True) > pg.MAX_SMEM_BYTES
    four = _check_plan(1, 64 * 64, 512, 1, 2)
    assert (four.cluster, four.resident) == (8, False)


def test_plan_rejects_misaligned_channels():
    with pytest.raises(ValueError):
        pg.gn_plan(1, 16, 20, 4, 2)  # C % 8 != 0
