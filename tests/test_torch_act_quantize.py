"""The activation quantize of the port's int8 ops (csrc/act_quantize.cuh), on
the CPU: a plain model of the kernel's walk (a grid of at most 8 blocks an
SM of 256 threads; 16 elements a thread a step where x and q are 16-byte
aligned, then the scalar tail, or every element one at a time where they
are not) covers every element once and gives the values of
quantize_int8_plain and of the JAX quantize_int8, ties included; and every
int8 op of the port (conv, dense, GEGLU, fused self-attention) counts one
quantize a call on its CPU path, as on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import quant as jq
from d3roma_tpu_torch.ops import quant as tq
from d3roma_tpu_torch.ops.kernels import attention_fused as pf
from d3roma_tpu_torch.ops.kernels import conv2d as pc
from d3roma_tpu_torch.ops.kernels import geglu as pgg
from d3roma_tpu_torch.ops.kernels import quantize as pq
from torch_port_utils import randn

THREADS, BLOCKS_PER_SM, VEC, SMS = 256, 8, 16, 132


def _quantize_model(x: np.ndarray, scale: float, vec: bool) -> np.ndarray:
    """The kernel's walk over flat fp32 values x: each element written once,
    as clip(rint(x / scale), -127, 127) with an IEEE fp32 division."""
    n = x.size
    n16 = n // VEC if vec else 0
    work = max(n16, n - n16 * VEC)
    grid = max(1, min(-(-work // THREADS), SMS * BLOCKS_PER_SM))
    stride = grid * THREADS
    q = np.zeros(n, np.int8)
    written = np.zeros(n, np.int32)
    s = np.float32(scale)

    def quant(v):
        return np.clip(np.rint(v.astype(np.float32) / s), -127, 127).astype(np.int8)

    for first in range(stride):  # thread blockIdx.x * 256 + threadIdx.x
        vecs = np.arange(first, n16, stride)
        for i in vecs:
            q[i * VEC:(i + 1) * VEC] = quant(x[i * VEC:(i + 1) * VEC])
            written[i * VEC:(i + 1) * VEC] += 1
        tail = np.arange(n16 * VEC + first, n, stride)
        q[tail] = quant(x[tail])
        written[tail] += 1
    assert (written == 1).all()
    return q


def _ties(n, scale, seed):
    """bf16 values with exact ties of x / scale (k + 0.5) and values past the
    clip, mixed with random ones."""
    rng = np.random.RandomState(seed)
    k = rng.randint(-140, 140, size=n).astype(np.float32)
    x = np.where(rng.rand(n) < 0.5, (k + 0.5) * np.float32(scale), rng.randn(n) * 40 * scale)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("n,vec", [(4103, True), (4096 * 3, True), (33, False), (7, True),
                                   (SMS * BLOCKS_PER_SM * THREADS * VEC + 40, True)])
def test_walk_matches_plain_and_jax(n, vec):
    scale = 0.25  # x / scale = k + 0.5 exactly for the ties
    xb = _ties(n, scale, n)
    ref = pq.quantize_int8_plain(xb, scale).numpy()
    out = _quantize_model(xb.float().numpy(), scale, vec)
    np.testing.assert_array_equal(out, ref)
    jref = np.asarray(jax.jit(jq.quantize_int8)(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                                jnp.float32(scale)))
    np.testing.assert_array_equal(out, jref)
    ratio = np.abs(xb.float().numpy() / scale)
    halves = (ratio % 1 == 0.5) & (ratio < 127)
    assert halves.sum() > n // 4  # ties are there, and went to the even neighbour
    assert (out[halves] % 2 == 0).all()


def _conv_operands(cin, cout, k):
    wq, ws = tq.quantize_weight(torch.from_numpy(randn(1, cout, k, k, cin, scale=0.1)))
    return wq, ws


def test_one_quantize_counted_per_int8_op():
    """conv2d_int8 (each epilogue), int8_linear (the dense layers' CPU path),
    geglu_ff_int8 and fused_self_attention_int8 each count one quantize a
    call on the CPU, and quantize_int8_scalar counts itself."""
    scale = 0.05
    x4 = torch.from_numpy(randn(0, 1, 5, 6, 32)).to(torch.bfloat16)
    wq, ws = _conv_operands(32, 16, 3)
    calls = [lambda e=e: pc.conv2d_int8(x4, wq, ws, scale, None, 1, 1, e)
             for e in pc.EPILOGUES]
    lw, ls = _conv_operands(32, 24, 1)
    x3 = torch.from_numpy(randn(1, 2, 7, 32)).to(torch.bfloat16)
    calls.append(lambda: tq.int8_linear(x3, lw.view(24, 32), ls, scale))
    c, f = 32, 128
    (w1hq, s1h), (w1gq, s1g) = (tq.quantize_weight(torch.from_numpy(randn(s, f, c, scale=0.2)))
                                for s in (2, 3))
    w2q, s2 = tq.quantize_weight(torch.from_numpy(randn(4, c, f, scale=0.1)))
    b1 = torch.zeros(f)
    calls.append(lambda: pgg.geglu_ff_int8(x3, w1hq, w1gq, w2q, s1h, s1g, s2, b1, b1,
                                           torch.zeros(c), scale))
    wqkv, sw = tq.quantize_weight(torch.from_numpy(randn(5, 3 * 64, 64, scale=0.1)))
    wo = torch.from_numpy(randn(6, 64, 64, scale=0.1)).to(torch.bfloat16)
    x_attn = torch.from_numpy(randn(7, 1, 9, 64)).to(torch.bfloat16)
    calls.append(lambda: pf.fused_self_attention_int8(x_attn, wqkv, sw, wo, torch.zeros(64), 1,
                                                      scale))
    calls.append(lambda: pq.quantize_int8_scalar(x3, scale))
    for call in calls:
        before = pq.quantize_int8_scalar.launches
        call()
        assert pq.quantize_int8_scalar.launches == before + 1


def test_workspace_grows_and_is_reused():
    """One buffer a (device, stream), reused while it is large enough and
    replaced by one of the next power of two (at least 1 MiB) when not."""
    dev, stream = torch.device("cpu"), -12345
    a = pq.act_workspace(dev, stream, 1000)
    assert pq.act_workspace(dev, stream, 1 << 20) == a
    assert pq._workspaces[(dev.index, stream)][1] == 1 << 20
    pq.act_workspace(dev, stream, (1 << 20) + 1)
    assert pq._workspaces[(dev.index, stream)][1] == 1 << 21
    assert pq.act_workspace(dev, stream + 1, 10) != pq.act_workspace(dev, stream, 10)
    for key in [(dev.index, stream), (dev.index, stream + 1)]:
        del pq._workspaces[key]
