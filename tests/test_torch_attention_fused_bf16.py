"""The port's fused bf16 self-attention (on the CPU: its plain version)
against the JAX Pallas kernel's bf16 body (quant=None) in interpret mode on
the same numpy inputs; the bf16 gate at the flagship sites; and the routes a
CrossAttention takes with use_flash="fused" and use_flash=True without int8.

Tolerance: both sides compute the same products with fp32 sums in another
order (the projections, the softmax denominator, the output projection) and
exp in the last place; with fp32 inputs nothing else rounds, so 1e-5 of
max |output|. With bf16 inputs q, k, v, P and o_h are rounded to bf16 on
both sides, and a last-place difference before a rounding moves a value by
one bf16 ulp (2^-8 relative): 2e-2 of max |output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.models import layers as jax_layers
from d3roma_tpu.ops.pallas import attention_fused as jax_fused
from d3roma_tpu_torch.models import layers as port_layers
from d3roma_tpu_torch.models.layers import CrossAttention, dot_product_attention
from d3roma_tpu_torch.ops.kernels import attention_fused as port_fused
from d3roma_tpu_torch.ops.kernels import mha_attention
from torch_port_utils import randn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, n, c, seed=0):
    x = randn(seed, b, n, c)
    w = [randn(seed + 1 + i, c, c, scale=c ** -0.5) for i in range(4)]  # [in, out]
    bo = randn(seed + 5, c, scale=0.1)
    return x, w, bo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c,heads", [
    (2, 256, 64, 1),
    (1, 300, 128, 2),   # ragged: the TPU kernel pads to 512 tokens and masks
])
def test_plain_matches_pallas_bf16_kernel(b, n, c, heads, dtype):
    x, (wq, wk, wv, wo), bo = _inputs(b, n, c)
    jd = getattr(jnp, dtype)
    ref = np.asarray(jax_fused.fused_self_attention(
        jnp.asarray(x, jd), *(jnp.asarray(w, jd) for w in (wq, wk, wv, wo)), jnp.asarray(bo),
        heads=heads, quant=None, interpret=True).astype(jnp.float32))
    td = getattr(torch, dtype)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(td)

    wqkv = torch.cat([t(w.T) for w in (wq, wk, wv)])
    before = port_fused.fused_self_attention_bf16.launches
    out = port_fused.fused_self_attention_bf16(t(x), wqkv, t(wo.T), torch.from_numpy(bo), heads)
    assert port_fused.fused_self_attention_bf16.launches == before + 1
    assert out.dtype == td and tuple(out.shape) == (b, n, c)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("n,c,admitted", [
    (3600, 320, False), (920, 640, True), (240, 1280, False), (60, 1280, False)])
def test_bf16_gate_at_the_flagship_sites(n, c, admitted):
    """At itemsize 2 the gate admits only the 920-token sites (C = 640);
    the 3600-token sites overflow it on their score row, the 1280-wide ones
    on their QKV weights. The int8 gate admits all four."""
    assert port_fused.fused_attention_supported(n, c, 64, itemsize=2) is admitted
    assert jax_fused.fused_attention_supported(n, c, 64, itemsize=2) is admitted
    assert port_fused.fused_attention_supported(n, c, 64, itemsize=1)


def _attention(c, use_flash, seed=3):
    attn = CrossAttention(c, c // 64, 64, use_flash=use_flash)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy(randn(seed, *p.shape, scale=c ** -0.5)))
            seed += 1
    return attn.to(torch.bfloat16)


def test_fused_route_runs_the_bf16_body_where_the_gate_admits():
    """use_flash="fused" without int8: an admitted self-attention site (bf16
    weights, itemsize 2) takes the bf16 fused kernel on the weights as they
    are; cross-attention stays unfused."""
    attn = _attention(128, "fused")
    x = torch.from_numpy(randn(9, 1, 300, 128)).to(torch.bfloat16)
    before = port_fused.fused_self_attention_bf16.launches
    with torch.no_grad():
        out = attn(x)
        ctx = torch.from_numpy(randn(10, 1, 7, 128)).to(torch.bfloat16)
        attn(x, ctx)
    assert port_fused.fused_self_attention_bf16.launches == before + 1
    w = [attn.to_q.weight, attn.to_k.weight, attn.to_v.weight]
    ref = port_fused.fused_self_attention_bf16_plain(
        x, torch.cat(w), attn.to_out[0].weight, attn.to_out[0].bias, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("use_flash,c,n_long,n_short,min_seq", [
    (True, 128, 1100, 600, 1024),
    ("fused", 1280, 64, 16, 32),   # C = 1280: the bf16 fused gate refuses every N
])
def test_flash_route_takes_the_whole_row_kernel_at_long_self_attention(
        use_flash, c, n_long, n_short, min_seq, monkeypatch):
    """A truthy use_flash sends a self-attention site of >= FLASH_MIN_SEQ
    tokens that no other kernel took to the whole-row bf16 kernel (the JAX
    package's TPU flash route); shorter sites stay plain."""
    attn = _attention(c, use_flash)
    monkeypatch.setattr(port_layers, "FLASH_MIN_SEQ", min_seq)
    h = c // 64
    for n, taken in ((n_long, 1), (n_short, 0)):
        assert not port_fused.fused_attention_supported(n, c, 64, itemsize=2) or \
            use_flash is True
        x = torch.from_numpy(randn(11, 1, n, c)).to(torch.bfloat16)
        before = mha_attention.launches, port_fused.fused_self_attention_bf16.launches
        with torch.no_grad():
            out = attn(x)
            q, k, v = (lin(x).reshape(1, n, h, 64) for lin in (attn.to_q, attn.to_k, attn.to_v))
            ref = attn.to_out[0](dot_product_attention(q, k, v).reshape(1, n, c))
        assert (mha_attention.launches - before[0],
                port_fused.fused_self_attention_bf16.launches - before[1]) == (taken, 0)
        assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
    monkeypatch.setattr(port_layers, "FLASH_MIN_SEQ", n_long + 1)
    before = mha_attention.launches
    with torch.no_grad():
        attn(torch.from_numpy(randn(12, 1, n_long, c)).to(torch.bfloat16))
    assert mha_attention.launches == before


def test_refused_site_matches_the_jax_cross_attention(monkeypatch):
    """A 1280-wide self-attention site (the bf16 fused gate refuses it at
    every N) under use_flash="fused": the port's flash route (the whole-row
    kernel, here its plain version) against the JAX CrossAttention, which
    off the TPU takes XLA's attention there. bf16 weights and inputs on both
    sides; tolerance 2e-2 of max |output| (bf16 roundings in other places)."""
    c, n = 1280, 48
    attn = _attention(c, "fused")
    monkeypatch.setattr(port_layers, "FLASH_MIN_SEQ", 32)
    x = torch.from_numpy(randn(13, 2, n, c)).to(torch.bfloat16)
    before = mha_attention.launches, port_fused.fused_self_attention_bf16.launches
    with torch.no_grad():
        out = attn(x).float().numpy()
    assert (mha_attention.launches - before[0],
            port_fused.fused_self_attention_bf16.launches - before[1]) == (1, 0)

    def kernel(lin):
        return jnp.asarray(lin.weight.detach().float().t().numpy())

    params = {"to_q": {"kernel": kernel(attn.to_q)}, "to_k": {"kernel": kernel(attn.to_k)},
              "to_v": {"kernel": kernel(attn.to_v)},
              "to_out": {"kernel": kernel(attn.to_out[0]),
                         "bias": jnp.asarray(attn.to_out[0].bias.detach().float().numpy())}}
    module = jax_layers.CrossAttention(query_dim=c, heads=c // 64, head_dim=64,
                                       use_flash="fused", dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(module.apply)({"params": params},
                                           jnp.asarray(x.float().numpy(), jnp.bfloat16)),
                     np.float32)
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
