"""The host plan of the CUDA int8 whole-row attention kernel (ops/kernels/
attention.py::rows_plan) and a plain-torch model of the kernel's walk
(csrc/attention_int8_rows.cuh), on the CPU: 128-row query blocks that read
one q scale, 128-key tiles, the pass-1 integer row max with the keys past M
masked, the pass-2 P = round(127 exp(s - max)) and its int32 product with V;
the model against the JAX Pallas kernels in interpret mode (the standalone
attention and the fused self-attention's 256-row q scale blocks), and the
plan's grid, masks, maps and q_rows check."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import attention as jax_attention
from d3roma_tpu.ops.pallas import attention_fused as jax_fused
from d3roma_tpu_torch.ops.kernels import attention as pa
from d3roma_tpu_torch.ops.kernels import attention_fused as pf
from d3roma_tpu_torch.ops.kernels.quantize import fp32, quantize_int8_plain, quantize_weight
from torch_port_utils import randn

# as tests/test_torch_attention.py and test_torch_attention_fused.py hold the
# plain versions to the TPU kernels: exact integer sums on both sides; exp
# in the last place and the denominator's order move round(127 p) by one
# quantum for a few keys
INT8_TOL = 2e-3
FUSED_REL_TOL = 5e-3
INT_MIN = -2**31


def _rows_model(qq, kq, vq, sq_rows, sk, sv, scale, q_rows, dtype):
    """The kernel's walk. qq [B, N, H, D], kq and vq [B, M, H, D] (integers
    as fp32); sq_rows [B, N, H] each query row's q scale, sk and sv [B, H].
    Per (query block, head, batch) of the plan's grid: c from the block's
    one q scale; pass 1 over the key tiles keeps each row's integer max of
    the valid keys; pass 2: p = exp(float(s) c - max) (0 past M) into the
    fp32 denominator, round(127 p) times V summed exactly; out =
    ((acc sv / 127) / denom), rounded to `dtype` (the kernel's bf16, or the
    fp32 of an fp32 reference). Returns [B, N, H, D]."""
    b, n, h, d = qq.shape
    m = kq.shape[1]
    plan = pa.rows_plan(b, n, m, h, d, q_rows, -(-m // 64) * 64)
    out = torch.empty((b, n, h, d), dtype=dtype)
    sv127 = pa.ieee_div(sv, 127.0)
    for bi in range(plan.grid[2]):
        for hi in range(plan.grid[1]):
            for blk in range(plan.grid[0]):
                rows = slice(blk * pa.ROWS_BLOCK, min((blk + 1) * pa.ROWS_BLOCK, n))
                block_sq = sq_rows[bi, rows, hi]
                assert (block_sq == block_sq[0]).all()  # one q scale a block
                c = (torch.tensor(fp32(scale)) * block_sq[0]) * sk[bi, hi]
                q = qq[bi, rows, hi].double()
                tiles = []
                for t in range(plan.key_tiles):
                    keys = slice(t * pa.ROWS_KEYS, (t + 1) * pa.ROWS_KEYS)
                    valid = min(pa.ROWS_KEYS, m - t * pa.ROWS_KEYS)
                    assert valid == (plan.last_keys if t == plan.key_tiles - 1 else pa.ROWS_KEYS)
                    tiles.append((keys, (q @ kq[bi, keys, hi].double().t()).float()))
                run_max = torch.full((q.shape[0],), float(INT_MIN))
                for _, s in tiles:
                    run_max = torch.maximum(run_max, s.max(dim=1).values)
                m_row = run_max * c
                denom = torch.zeros(q.shape[0])
                acc = torch.zeros((q.shape[0], d), dtype=torch.float64)
                for keys, s in tiles:
                    p = torch.exp(s * c - m_row[:, None])
                    denom = denom + p.sum(dim=1)
                    acc = acc + torch.round(p * 127.0).double() @ vq[bi, keys, hi].double()
                out[bi, rows, hi] = ((acc.float() * sv127[bi, hi]) / denom[:, None]).to(dtype)
    return out


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 300, 1000, 2, 64),   # N and M off the 128-row and 128-key tiles
    (2, 1000, 300, 1, 32),
])
def test_rows_model_matches_pallas_int8_kernel(b, n, m, h, d):
    q, k, v = (randn(seed, b, length, h, d) for seed, length in ((11, n), (12, m), (13, m)))
    ref = np.asarray(jax_attention.mha_attention(*map(jnp.asarray, (q, k, v)), quant="int8",
                                                 interpret=True))
    (qq, sq), (kq, sk), (vq, sv) = (pa.quantize_per_head(torch.from_numpy(t)) for t in (q, k, v))
    sq_rows = sq[:, None, :].expand(b, n, h)
    out = _rows_model(qq.float(), kq.float(), vq.float(), sq_rows, sk, sv, 1.0 / math.sqrt(d),
                      n, torch.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=INT8_TOL * np.abs(ref).max(),
                               rtol=0)


def test_rows_model_takes_256_row_q_blocks_of_the_fused_kernel():
    """The fused self-attention's q scale changes every 256 rows; the model
    (and the kernel) read it once per 128-row block. N = 300: the second
    scale block is ragged."""
    b, n, c, heads = 1, 300, 128, 2
    x = randn(20, b, n, c)
    wq, wk, wv, wo = (randn(21 + i, c, c, scale=c ** -0.5) for i in range(4))
    bo = randn(25, c, scale=0.1)
    act = fp32(np.abs(x).max() * 1.25 / 127)
    ref = np.asarray(jax_fused.fused_self_attention(
        jnp.asarray(x), *(jnp.asarray(w) for w in (wq, wk, wv, wo)), jnp.asarray(bo),
        heads=heads, quant="static", act_scale=act, interpret=True))
    # the projections and scales of fused_self_attention_int8_plain
    qs = [quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T))) for w in (wq, wk, wv)]
    wqkv, ws = torch.cat([q for q, _ in qs]), torch.cat([s for _, s in qs])
    xt = torch.from_numpy(x)
    f = pf._exact_matmul(quantize_int8_plain(xt, act), wqkv.t()) * (torch.tensor(act) * ws)
    qf, kf, vf = (t.reshape(b, n, heads, 64) for t in f.split(c, dim=-1))
    sk, sv = (pf._head_scale(t.abs().amax(dim=(1, 3))) for t in (kf, vf))
    qpad = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, 512 - n))
    sq = pf._head_scale(qpad.reshape(b, 2, 256, heads, 64).abs().amax(dim=(2, 4)))
    sq_rows = sq.repeat_interleave(256, dim=1)[:, :n]
    assert not torch.equal(sq_rows[:, 0], sq_rows[:, 256])
    qq = torch.round(torch.div(qf, sq_rows[..., None]))
    kq = torch.round(torch.div(kf, sk[:, None, :, None]))
    vq = torch.round(torch.div(vf, sv[:, None, :, None]))
    o = _rows_model(qq, kq, vq, sq_rows, sk, sv, 1.0 / 8.0, 256, torch.bfloat16)
    out = pf._out_projection(o, torch.from_numpy(np.ascontiguousarray(wo.T)),
                             torch.from_numpy(bo), heads).numpy()
    assert np.abs(out - ref).max() <= FUSED_REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("b,n,m,h,d,q_rows", [
    (2, 3600, 3600, 5, 64, 3600),   # the UNet's 3600-token level (bench default)
    (2, 920, 920, 10, 64, 920),     # the 920-token level
    (2, 3600, 3600, 5, 64, 256),    # the fused self-attention at 3600 tokens
    (2, 60, 60, 20, 64, 256),       # and at 60 (one block, one ragged tile)
    (1, 129, 1, 1, 128, 129),       # one key; a block past the first
    (1, 100, 130, 2, 96, 100),
])
def test_rows_plan(b, n, m, h, d, q_rows):
    m_pad = -(-m // 64) * 64
    plan = pa.rows_plan(b, n, m, h, d, q_rows, m_pad)
    assert plan.grid == (-(-n // 128), h, b)
    assert plan.key_tiles * 128 >= m > (plan.key_tiles - 1) * 128
    assert 1 <= plan.last_keys <= 128
    assert plan.last_keys + 128 * (plan.key_tiles - 1) == m
    # K-major boxes of 128 bytes: q, k as (D, H, B L); vt as [B H D, Mp]
    assert plan.q_map == ((d, h, b * n), (128, 1, 128))
    assert plan.k_map == ((d, h, b * m), (128, 1, 128))
    assert plan.v_map == ((m_pad, b * h * d), (128, d))
    assert plan.q_scales == -(-n // q_rows)
    # every block's rows share one q scale
    for blk in range(plan.grid[0]):
        first, last = blk * 128, min(blk * 128 + 127, n - 1)
        assert first // q_rows == last // q_rows


@pytest.mark.parametrize("q_rows", [64, 192, 200])
def test_rows_plan_refuses_a_q_rows_a_block_would_straddle(q_rows):
    with pytest.raises(ValueError, match="straddle"):
        pa.rows_plan(1, 300, 300, 1, 64, q_rows, 320)
    pa.rows_plan(1, 300, 300, 1, 64, 300, 320)   # one scale per (batch, head)
    pa.rows_plan(1, 300, 300, 1, 64, 256, 320)   # the fused kernel's blocks
    pa.rows_plan(1, q_rows, 300, 1, 64, q_rows, 320)  # q_rows >= N: one scale


@pytest.mark.parametrize("args", [
    (1, 300, 300, 1, 48, 300, 320),    # head width off the kernel's menu
    (1, 300, 300, 1, 256, 300, 320),   # the wide kernel's width
    (1, 300, 300, 1, 64, 300, 256),    # vt shorter than M
    (1, 300, 300, 1, 64, 300, 328),    # a row pitch TMA cannot take
])
def test_rows_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        pa.rows_plan(*args)
