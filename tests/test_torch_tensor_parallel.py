"""The port's tensor-parallel compositions and sharded models against the
JAX package's, at tp = 2: the port in two spawned processes of a gloo
group (a file:// store, the CPU), the JAX side in this process on
`make_mesh_dp_tp(1, 2)` of the 8 virtual CPU devices, its Pallas kernels
in interpret mode. The same numpy inputs and weights go to both.

- `mha_attention_tp` (bf16 route and int8) against JAX's `mha_attention_tp`:
  each rank's N/2 q rows against the whole K/V, then gathered; the int8 q
  scales are the local rows' absmax. Tolerance ATTN_ATOL on values of
  magnitude ~1 (the port's int8 arithmetic is the kernel's, so the int32
  sums agree exactly and only fp32 rounding differs);
- `geglu_ff_tp` (float and static int8) against JAX's: each rank's F chunk
  (W2's int8 scales the chunk's), one all-reduce, b2 once; GEGLU_RTOL of
  max |ref|;
- the `_kernel_unet` of tests/test_tensor_parallel.py (512 tokens at head
  dim 64, C = 128) under TP2, every attention site through
  `mha_attention_tp` and every feed-forward through `geglu_ff_tp`, against
  JAX's TP2 forward: UNET_RTOL of max |ref| (fp32);
- the static-int8 VAE encode of tests/test_tensor_parallel.py's
  `test_vae_pallas_attention_tp_matches_replicated` (the mid attention's
  512 tokens through the int8 composition, every conv and dense at the
  default static scale): the port's TP2 encode within VAE_RTOL of max
  |ref| of its own unsharded encode (that JAX test's tolerance for JAX's
  TP against JAX's replicated run), and within VAE_NOISE x the distance
  between the two packages' unsharded encodes of the JAX TP2 encode. int8
  parity between the packages is statistical (a last-place float
  difference before a quantization moves a value by one quantum, and the
  layers after amplify it): on this model the unsharded encodes differ by
  ~6% of max |ref|, TP adds < 1% in either package.

Every rank returns the same output; the plain compositions equal the
wrappers on the CPU (the wrappers take them for CPU tensors); and
`replicate_state` / `broadcast_object` give every rank rank 0's values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.ops.pallas import mha_attention_tp as jax_mha_tp
from d3roma_tpu.ops.pallas.geglu import geglu_ff_tp as jax_geglu_tp
from d3roma_tpu.parallel import batch_sharding, make_mesh_dp_tp, shard_params_tp
from d3roma_tpu_torch.models import flax_unet_to_torch, flax_vae_to_torch
import torch_port_utils as U

ATTN_ATOL = 1e-5
GEGLU_RTOL = 1e-5
UNET_RTOL = 1e-4
VAE_RTOL = 2e-2
VAE_NOISE = 1.25

KERNEL_UNET = dict(
    in_channels=12, out_channels=4, block_out_channels=(128, 128),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, attention_head_dim=64, cross_attention_dim=16,
    norm_groups=4, use_flash_attention="pallas-self", fused_ff=True,
)
INT8_VAE = dict(block_out_channels=(8, 8, 16, 64), latent_channels=4, norm_groups=4)


def _ranks_agree(outs):
    for o in outs[1:]:
        jax.tree.map(np.testing.assert_array_equal, outs[0], o)
    return outs[0]


def test_attention_tp_matches_jax():
    q, k, v = (U.randn(s, 2, 512, 2, 64) for s in (1, 2, 3))
    ours = _ranks_agree(U.run_ranks(U.tp_attention_ranks, 2, q, k, v))
    state, obj = ours["replicated"]  # rank 0's on both ranks (replicate_state, broadcast_object)
    assert obj == {"rank": 0}
    np.testing.assert_array_equal(state["w"], np.zeros(3, np.float32))
    np.testing.assert_array_equal(state["i"], np.arange(2))
    mesh = make_mesh_dp_tp(1, 2)
    for case, quant in (("bf16", None), ("int8", "int8")):
        ref = np.asarray(jax_mha_tp(*(jnp.asarray(a) for a in (q, k, v)), mesh, quant=quant,
                                    interpret=True))
        out, plain = ours[case]
        np.testing.assert_array_equal(out, plain)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_ATOL, err_msg=case)


def test_geglu_tp_matches_jax():
    c, f = 128, 512
    x = U.randn(4, 2, 64, c)
    w1h, w1g = U.randn(5, c, f, scale=c ** -0.5), U.randn(6, c, f, scale=c ** -0.5)
    w2 = U.randn(7, f, c, scale=f ** -0.5)
    b1h, b1g, b2 = U.randn(8, f, scale=0.1), U.randn(9, f, scale=0.1), U.randn(10, c, scale=0.1)
    act_scale = float(np.abs(x).max() / 127)
    ours = _ranks_agree(U.run_ranks(U.tp_geglu_ranks, 2, x, w1h, w1g, w2, b1h, b1g, b2,
                                    act_scale))
    mesh = make_mesh_dp_tp(1, 2)
    args = [jnp.asarray(a) for a in (x, w1h, w1g, w2, b1h, b1g, b2)]
    for case, quant in (("float", None), ("int8", "static")):
        ref = np.asarray(jax_geglu_tp(*args, mesh, quant=quant, act_scale=act_scale,
                                      interpret=True))
        out, plain = ours[case]
        np.testing.assert_array_equal(out, plain)
        np.testing.assert_allclose(out, ref, rtol=0, atol=GEGLU_RTOL * np.abs(ref).max(),
                                   err_msg=case)


def test_kernel_unet_tp2_matches_jax(monkeypatch):
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    lat, ctx = U.randn(11, 2, 16, 32, 12, scale=0.3), U.randn(12, 2, 4, 16, scale=0.3)
    t = np.array([3, 5], np.int32)
    unet = JaxUNet(**KERNEL_UNET)
    params = U.random_flax_tree(unet, 13, lat[:1], t[:1], ctx[:1])
    state = {k: v.numpy() for k, v in flax_unet_to_torch(params).items()}
    outs = U.run_ranks(U.tp_unet_ranks, 2, KERNEL_UNET, state, lat, t, ctx)
    out, launches = _ranks_agree(outs)
    # every self-attention site (3 at 512 tokens) and feed-forward (4) took
    # the compositions, on the kernels' wrappers
    assert launches["mha_attention_tp"] == launches["mha_attention"] == 3
    assert launches["geglu_ff_tp"] == launches["geglu_ff"] == 4

    mesh = make_mesh_dp_tp(1, 2)
    unet_tp = dataclasses.replace(unet, tp_mesh=mesh)
    args = jax.device_put(tuple(jnp.asarray(a) for a in (lat, t, ctx)), batch_sharding(mesh))
    ref = np.asarray(jax.jit(lambda p, *a: unet_tp.apply({"params": p}, *a))(
        shard_params_tp(jax.tree.map(jnp.asarray, params), mesh), *args))
    np.testing.assert_allclose(out, ref, rtol=0, atol=UNET_RTOL * np.abs(ref).max())


def test_int8_vae_encode_tp2_matches_jax(monkeypatch):
    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    x = U.randn(14, 2, 256, 128, 3, scale=0.3)
    vae = JaxVAE(**INT8_VAE, quant="static")
    params = U.random_flax_tree(vae, 15, x[:1])
    state = {k: v.numpy() for k, v in flax_vae_to_torch(params).items()}
    whole, out, launches = _ranks_agree(U.run_ranks(U.tp_vae_encode_ranks, 2, INT8_VAE,
                                                    state, x, "static"))
    assert launches["mha_attention_tp"] == launches["mha_attention_int8"] == 1

    def encode(v):
        return jax.jit(lambda p, xx: v.apply({"params": p}, xx, method=v.encode).mean)

    mesh = make_mesh_dp_tp(1, 2)
    ref_whole = np.asarray(encode(vae)(params, x))
    ref = np.asarray(encode(dataclasses.replace(vae, tp_mesh=mesh))(
        shard_params_tp(jax.tree.map(jnp.asarray, params), mesh),
        jax.device_put(jnp.asarray(x), batch_sharding(mesh))))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, whole, rtol=0, atol=VAE_RTOL * scale)
    noise = float(np.abs(whole - ref_whole).max())
    assert 0 < noise < 0.1 * scale
    np.testing.assert_allclose(out, ref, rtol=0, atol=VAE_NOISE * noise)
