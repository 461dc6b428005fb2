"""The port's fused int8 self-attention (on the CPU: its plain version)
against the JAX Pallas kernel's int8 body in interpret mode, on the same
numpy inputs; and its gate against the JAX gate at every flagship site."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import attention_fused as jax_fused
from d3roma_tpu_torch.ops.kernels import attention_fused as port_fused
from d3roma_tpu_torch.ops.quant import fp32, quantize_weight
from torch_port_utils import randn

# Every integer sum is exact on both sides and the fp32 products are the
# same; what differs is the order of the fp32 sums (the softmax denominator,
# the 64-term products of the output projection) and exp in the last place.
# A last-place change of p can move round(127 p) by one quantum (1/127 of a
# probability), which the output projection carries to ~1e-3 of the output;
# o_h is rounded to bf16 (2^-8 relative) on both sides. Bound: 5e-3 of
# max |output|.
REL_TOL = 5e-3


def _inputs(b, n, c, seed=0):
    x = randn(seed, b, n, c)
    w = [randn(seed + 1 + i, c, c, scale=c ** -0.5) for i in range(4)]  # [in, out]
    bo = randn(seed + 5, c, scale=0.1)
    return x, w, bo


@pytest.mark.parametrize("b,n,c,heads", [
    (2, 512, 64, 1),
    (1, 300, 128, 2),   # the last 256-row q block is padded
])
def test_plain_matches_pallas_int8_kernel(b, n, c, heads):
    x, (wq, wk, wv, wo), bo = _inputs(b, n, c)
    act = fp32(np.abs(x).max() * 1.25 / 127)
    ref = np.asarray(jax_fused.fused_self_attention(
        jnp.asarray(x), *(jnp.asarray(w) for w in (wq, wk, wv, wo)), jnp.asarray(bo),
        heads=heads, quant="static", act_scale=act, interpret=True))
    qs = [quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T))) for w in (wq, wk, wv)]
    wqkv = torch.cat([q for q, _ in qs])
    ws = torch.cat([s for _, s in qs])
    before = port_fused.fused_self_attention_int8.launches
    out = port_fused.fused_self_attention_int8(
        torch.from_numpy(x), wqkv, ws, torch.from_numpy(np.ascontiguousarray(wo.T)),
        torch.from_numpy(bo), heads, act)
    assert port_fused.fused_self_attention_int8.launches == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, n, c)
    err = np.abs(out.numpy() - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def test_plain_is_close_to_float_attention():
    """The int8 arithmetic stays near the float attention it replaces (a
    wrong scale grid or denominator would not)."""
    x, (wq, wk, wv, wo), bo = _inputs(1, 300, 128, seed=10)
    act = fp32(np.abs(x).max() * 1.25 / 127)
    qs = [quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T))) for w in (wq, wk, wv)]
    out = port_fused.fused_self_attention_int8_plain(
        torch.from_numpy(x), torch.cat([q for q, _ in qs]), torch.cat([s for _, s in qs]),
        torch.from_numpy(np.ascontiguousarray(wo.T)), torch.from_numpy(bo), 2, act).numpy()
    q, k, v = (x @ w for w in (wq, wk, wv))
    heads = [slice(0, 64), slice(64, 128)]
    o = np.concatenate([_softmax(q[..., h] @ k[..., h].transpose(0, 2, 1) / 8.0) @ v[..., h]
                        for h in heads], axis=-1)
    ref = o @ wo + bo
    assert np.abs(out - ref).max() <= 0.1 * np.abs(ref).max()


def _softmax(s):
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


_SITES = [(3600, 320), (920, 640), (240, 1280), (60, 1280), (512, 64), (128, 128),
          (6144, 320), (6145, 320), (3600, 640), (920, 1280), (100, 96), (300, 128)]


@pytest.mark.parametrize("n,c", _SITES)
@pytest.mark.parametrize("itemsize", [1, 2])
def test_gate_matches_jax(n, c, itemsize):
    for head_dim in (64, 32):
        assert port_fused.fused_attention_supported(n, c, head_dim, itemsize) == \
            jax_fused.fused_attention_supported(n, c, head_dim, itemsize)
