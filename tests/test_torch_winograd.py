"""The port's Winograd F(2x2, 3x3) conv (on the CPU: its plain version)
against the JAX fused Pallas kernel in interpret mode and the JAX XLA
formulation, and the port's "wino_static" routing against the JAX
package's at every flagship conv shape."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas.winograd_fused import conv3x3_wino_fused
from d3roma_tpu.ops.pallas.winograd_fused import pick_config as jax_pick_config
from d3roma_tpu.ops.winograd import _wino_eligible, winograd_conv3x3
from d3roma_tpu_torch.ops import winograd as port_wino
from d3roma_tpu_torch.ops.kernels import winograd as port_kernel
from torch_port_utils import randn

# fp32 output: x and U are rounded to bf16 identically on both sides, so the
# two differ only by the order of the fp32 sums (the tap products over C and
# the transforms); bf16 output: one bf16 ulp (at most 2^-7 of the value)
FP32_REL = 1e-5
BF16_ULP = 2.0 ** -7


def _inputs(b, h, w, c, o):
    x = randn(0, b, h, w, c)
    wt = randn(1, 3, 3, c, o, scale=(9 * c) ** -0.5)  # HWIO
    return x, wt


def _port(x, wt, dtype):
    tdt = getattr(torch, dtype)
    w_oihw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))).to(tdt)
    u = port_kernel.winograd_weight(w_oihw)
    before = port_kernel.conv3x3_winograd.launches
    out = port_kernel.conv3x3_winograd(torch.from_numpy(x).to(tdt), u, tdt)
    assert port_kernel.conv3x3_winograd.launches == before + 1
    return out


@pytest.mark.parametrize("shape,tr", [
    ((2, 16, 16, 32, 64), 4),
    ((1, 7, 9, 32, 160), 4),    # odd H and W, O > 128 (two TPU o-blocks)
    ((2, 13, 20, 64, 32), 8),
])
def test_plain_matches_fused_pallas_kernel(shape, tr):
    x, wt = _inputs(*shape)
    ref = np.asarray(conv3x3_wino_fused(jnp.asarray(x), jnp.asarray(wt), block_tr=tr,
                                        interpret=True))
    out = _port(x, wt, "float32")
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert np.abs(out.numpy() - ref).max() <= FP32_REL * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(1, 9, 11, 32, 48), (2, 8, 6, 64, 136)])
def test_plain_matches_xla_winograd(shape):
    """The XLA formulation transforms x in fp32 before its bf16 rounding, the
    kernel after it; on bf16 inputs, which the models pass, they agree."""
    x, wt = _inputs(*shape)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(winograd_conv3x3(jnp.asarray(x), jnp.asarray(wt)))
    out = _port(x, wt, "float32")
    assert np.abs(out.numpy() - ref).max() <= FP32_REL * np.abs(ref).max()


def test_plain_matches_fused_pallas_kernel_bf16():
    x, wt = _inputs(1, 10, 12, 64, 64)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    ref = np.asarray(conv3x3_wino_fused(xb, wb, block_tr=4, interpret=True), np.float32)
    out = _port(np.array(xb.astype(jnp.float32)), np.array(wb.astype(jnp.float32)),
                "bfloat16")
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= BF16_ULP * np.abs(ref) + 1e-6), err.max()


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def _jax_route(b, h, w, c, o, stride, padding):
    bc = _wino_eligible(_Shape((b, h, w, c)), _Shape((3, 3, c, o)), (stride, stride), padding,
                        None, None, ("NHWC", "HWIO", "NHWC"), 1, 1)
    if bc is None or jax_pick_config((bc, h, w, c)) is None:
        return None
    return bc


# every 3x3 conv input of the flagship UNet (640x360 -> 45x80 latent) and
# VAE, (H, W, Cin, Cout), and a few more of the pins in test_winograd.py
_UNET = [(45, 80, c, 320) for c in (320, 640, 960)] + [(45, 80, 320, 640)] + \
    [(23, 40, c, 640) for c in (320, 640, 960, 1280, 1920)] + \
    [(12, 20, c, 1280) for c in (640, 1280, 1920, 2560)] + \
    [(6, 10, c, 1280) for c in (1280, 2560)] + [(45, 80, 12, 320), (45, 80, 320, 4)]
_VAE = [(360, 640, c, 128) for c in (3, 128, 256)] + [(180, 320, c, 256) for c in (128, 256, 512)] + \
    [(90, 160, c, 512) for c in (256, 512)] + [(45, 80, 512, 512), (45, 80, 4, 512),
                                                (45, 80, 512, 8)]


@pytest.mark.parametrize("batch", [2, 4, 16, 32])
def test_routing_matches_jax(batch, monkeypatch):
    monkeypatch.setenv("D3ROMA_WINO_CHUNK", "0")
    monkeypatch.delenv("D3ROMA_WINO_SLAB_MB", raising=False)
    for (h, w, c, o), (stride, padding) in itertools.product(
            _UNET + _VAE, [(1, "SAME"), (1, ((1, 1), (1, 1))), (2, ((1, 1), (1, 1))),
                           (2, "VALID"), (1, "VALID")]):
        ours = port_wino.wino_static_route((batch, h, w, c), (3, 3, c, o), (stride, stride),
                                           padding)
        assert ours == _jax_route(batch, h, w, c, o, stride, padding), (batch, h, w, c, o)


@pytest.mark.parametrize("env", [{"D3ROMA_WINO_CHUNK": "1"},
                                 {"D3ROMA_WINO_SLAB_MB": "64"},
                                 {"D3ROMA_WINO_CHUNK": "1", "D3ROMA_WINO_SLAB_MB": "300"}])
def test_routing_env_matches_jax(env, monkeypatch):
    """The liveness cap and the chunking switch, as the JAX package reads
    them: chunk sizes equal at every batch and shape."""
    monkeypatch.delenv("D3ROMA_WINO_SLAB_MB", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for batch, (h, w, c, o) in itertools.product((2, 4, 16, 32), _UNET + _VAE):
        ours = port_wino.wino_static_route((batch, h, w, c), (3, 3, c, o), (1, 1), "SAME")
        assert ours == _jax_route(batch, h, w, c, o, 1, "SAME"), (batch, h, w, c, o)


def test_flagship_pins(monkeypatch):
    """The JAX package's pinned policy (tests/test_winograd.py), read through
    the port's routing."""
    monkeypatch.setenv("D3ROMA_WINO_CHUNK", "0")
    monkeypatch.delenv("D3ROMA_WINO_SLAB_MB", raising=False)

    def route(b, h, w, c, o, s=1):
        return "static" if port_wino.wino_static_route(
            (b, h, w, c), (3, 3, c, o), (s, s), "SAME") is None else "fused"

    assert route(16, 45, 80, 320, 320) == "fused"
    assert route(16, 45, 80, 320, 640) == "fused"
    assert route(16, 23, 40, 640, 640) == "fused"
    assert route(16, 45, 80, 320, 320, s=2) == "static"
    assert route(16, 45, 80, 960, 320) == "static"
    assert route(16, 12, 20, 1280, 1280) == "static"
    assert route(32, 45, 80, 512, 512) == "fused"
    assert route(16, 45, 80, 512, 512) == "fused"
    assert route(16, 90, 160, 512, 512) == "static"
    assert route(16, 360, 640, 128, 128) == "static"


def test_chunked_site_runs_per_chunk(monkeypatch):
    """A batch over the cap with chunking on runs as a loop over chunks,
    one call each, with the same output as one call over the batch."""
    monkeypatch.setenv("D3ROMA_WINO_CHUNK", "1")
    monkeypatch.setenv("D3ROMA_WINO_SLAB_MB", "2")
    x, wt = _inputs(4, 16, 32, 32, 32)
    chunk = port_wino.wino_static_route(x.shape, (3, 3, 32, 32), (1, 1), "SAME")
    assert chunk is not None and chunk < 4
    u = port_kernel.winograd_weight(
        torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))))
    before = port_kernel.conv3x3_winograd.launches
    out = port_wino.winograd_conv(torch.from_numpy(x), u, torch.float32, None, chunk)
    assert port_kernel.conv3x3_winograd.launches == before + 4 // chunk
    whole = port_kernel.conv3x3_winograd(torch.from_numpy(x), u, torch.float32)
    np.testing.assert_array_equal(out.numpy(), whole.numpy())
