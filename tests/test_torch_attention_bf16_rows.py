"""The host plan of the CUDA bf16 whole-row attention kernel (ops/kernels/
attention.py::bf16_plan, tma_head_strides) and a plain-torch model of the
kernel's walk (csrc/attention_bf16_rows.cuh), on the CPU: 64-row query
blocks, 128-key tiles with the keys past M masked in the last, an
online softmax in the log2 domain (running max, O and the fp32 denominator
rescaled as the max grows), P cast to bf16 for the P V product; q, k and v
read through the plan's TMA map strides. The model is held against the JAX
Pallas kernel (_kernel_f32, interpret mode) at ragged N and M and strided
inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import attention as jax_attention
from d3roma_tpu_torch.ops.kernels import attention as pa
from torch_port_utils import randn

# both round P and the output to bf16 (2^-8 relative) from sums taken in
# another order; the running max instead of the row max changes only the
# rounding (tests/test_torch_attention.py's bf16 tolerance)
TOL = 2e-2
LOG2E = 1.4426950408889634


def _gather(flat, mp, length, b, h, d, offset=0):
    """[B, L, H, D] read from `flat` as the TMA map `mp` (dims, byte
    strides, box) addresses it, from element `offset` on."""
    dims, strides, _ = mp
    assert dims == (d, h, length, b)
    sh, sl, sb = (s // 2 for s in strides)
    return torch.as_strided(flat, (b, length, h, d), (sb, sl, sh, 1), offset)


def _bf16_model(q, k, v, scale, plan):
    """The kernel's walk on q [B, N, H, D], k, v [B, M, H, D] (bf16 values
    as fp32). Returns [B, N, H, D] in bf16."""
    b, n, h, d = q.shape
    m = k.shape[1]
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16)
    rows_n = pa.BF16_ROWS
    for bi in range(plan.grid[2]):
        for hi in range(plan.grid[1]):
            for blk in range(plan.grid[0]):
                rows = slice(blk * rows_n, min((blk + 1) * rows_n, n))
                qb = q[bi, rows, hi]
                m_run = torch.full((qb.shape[0],), -math.inf)
                l_run = torch.zeros(qb.shape[0])
                o = torch.zeros((qb.shape[0], d))
                for t in range(plan.key_tiles):
                    keys = slice(t * pa.BF16_KEYS, (t + 1) * pa.BF16_KEYS)
                    s = torch.full((qb.shape[0], pa.BF16_KEYS), -math.inf)
                    valid = plan.last_keys if t == plan.key_tiles - 1 else pa.BF16_KEYS
                    s[:, :valid] = (qb @ k[bi, keys, hi].t()) * (scale * LOG2E)
                    mx = torch.maximum(m_run, s.max(dim=1).values)
                    alpha = torch.exp2(m_run - mx)
                    p = torch.exp2(s - mx[:, None])
                    l_run = l_run * alpha + p.sum(dim=1)
                    vt = torch.zeros((pa.BF16_KEYS, d))
                    vt[:valid] = v[bi, keys, hi]
                    o = o * alpha[:, None] + p.to(torch.bfloat16).float() @ vt
                    m_run = mx
                out[bi, rows, hi] = (o * (1.0 / l_run)[:, None]).to(torch.bfloat16)
    return out


def _check(out, q, k, v):
    ref = jax_attention.mha_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                        for t in (q, k, v)), interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 200, 150, 2, 64),     # N and M off the 64-row blocks and the 128-key tiles
    (2, 70, 1, 1, 48),        # one key; a head narrower than the 64-column box
    (1, 130, 300, 1, 80),     # width 128: the second box half zero fill
])
def test_bf16_model_matches_pallas_kernel(b, n, m, h, d):
    q, k, v = (torch.from_numpy(randn(seed, b, length, h, d)).to(torch.bfloat16).float()
               for seed, length in ((51, n), (52, m), (53, m)))
    plan = pa.bf16_plan(b, n, m, h, d)
    _check(_bf16_model(q, k, v, 1.0 / math.sqrt(d), plan), q, k, v)


@pytest.mark.parametrize("layout", ["workspace", "padded"])
def test_bf16_model_reads_strided_inputs_through_the_plan_maps(layout):
    """q, k, v read in place from a [B, N, 3 H D] projection (the fused bf16
    attention's workspace), or with heads D + 16 apart, through the byte
    strides of the plan's TMA maps."""
    b, n, h, d = 2, 150, 2, 64
    if layout == "workspace":
        flat = torch.from_numpy(randn(61, b * n * 3 * h * d)).to(torch.bfloat16).float()
        st = (n * 3 * h * d, 3 * h * d, d)
        offsets = (0, h * d, 2 * h * d)
    else:
        flat = torch.from_numpy(randn(62, 3 * b * n * h * (d + 16))).to(torch.bfloat16).float()
        st = (n * h * (d + 16), h * (d + 16), d + 16)
        offsets = (0, b * n * h * (d + 16), 2 * b * n * h * (d + 16))
    plan = pa.bf16_plan(b, n, n, h, d, st, st, st)
    q, k, v = (_gather(flat, mp, n, b, h, d, off)
               for mp, off in zip((plan.q_map, plan.k_map, plan.v_map), offsets))
    views = torch.as_strided(flat, (b, n, h, d), st[:2] + (st[2], 1), offsets[1])
    assert pa.tma_head_strides(views.shape, views.stride()) == st
    _check(_bf16_model(q, k, v, 1.0 / math.sqrt(d), plan), q, k, v)


@pytest.mark.parametrize("b,n,m,h,d,strides", [
    (2, 3600, 3600, 5, 64, None),     # the latency path's 3600-token level
    (2, 920, 920, 10, 64, None),      # and its 920-token level
    (2, 920, 920, 10, 64, (920 * 1920, 1920, 64)),   # row 7′'s core, in place
    (1, 100, 130, 2, 128, None),
    (3, 70, 700, 1, 16, None),
])
def test_bf16_plan(b, n, m, h, d, strides):
    plan = pa.bf16_plan(b, n, m, h, d, strides, strides, strides)
    assert plan.grid == (-(-n // 64), h, b)
    assert plan.width == (64 if d <= 64 else 128)
    assert plan.stages == 2
    assert plan.key_tiles * 128 >= m > (plan.key_tiles - 1) * 128
    assert plan.last_keys + 128 * (plan.key_tiles - 1) == m
    sb, sl, sh = strides or (n * h * d, h * d, d)
    assert plan.q_map == ((d, h, n, b), (2 * sh, 2 * sl, 2 * sb), (64, 1, 64, 1))
    assert plan.k_map[2] == plan.v_map[2] == (64, 1, 128, 1)
    # a block's shared memory, and three blocks of width 64 an SM (228 KB,
    # 1 KB of it reserved per block)
    assert plan.smem_bytes <= 232448
    if plan.width == 64:
        assert 3 * (plan.smem_bytes + 1024) <= 233472


def test_tma_head_strides():
    x = torch.zeros(2, 30, 4, 64)
    assert pa.tma_head_strides(x.shape, x.stride()) == (30 * 256, 256, 64)
    # size-1 dimensions take the nested stride, whatever theirs
    y = torch.zeros(1, 30, 1, 64)
    assert pa.tma_head_strides(y.shape, (7, 64, 5, 1)) == (30 * 64, 64, 64)
    # [B, H, L, D] seen as [B, L, H, D]: not nested; strided D; odd pitch
    assert pa.tma_head_strides((2, 30, 4, 64), x.transpose(1, 2).stride()) is None
    assert pa.tma_head_strides((2, 30, 4, 32), (30 * 256, 256, 64, 2)) is None
    assert pa.tma_head_strides((2, 30, 4, 64), (30 * 260, 260, 65, 1)) is None


@pytest.mark.parametrize("args,kwargs", [
    ((1, 100, 100, 2, 24), {}),                      # head width off the menu
    ((1, 100, 100, 2, 144), {}),
    ((1, 100, 100, 2, 64), {"q_strides": (100 * 128, 64, 128)}),  # not nested
    ((1, 100, 100, 2, 64), {"k_strides": (100 * 132, 132, 66)}),  # 16-byte pitch
    ((0, 100, 100, 2, 64), {}),
])
def test_bf16_plan_refuses_what_the_kernel_cannot_take(args, kwargs):
    with pytest.raises(ValueError):
        pa.bf16_plan(*args, **kwargs)
