"""The port's parallel/ helpers against the JAX package's, in this process
(no process group: a `Mesh` built from its shape alone describes the
layout, and its collectives are not called):

- `pad_batch_to_devices` and `slice_process_local` equal the JAX ones on
  the same numpy batches (exactly);
- `tp_param_specs` and `tp_shard_count` equal the JAX ones at tp 2 and 4
  on the tiny UNet and VAE of tests/test_tensor_parallel.py, its
  `_kernel_unet` and the tiny pixel UNet2D, the JAX leaves named through
  `models/convert.py` and each spec read as the torch dim it shards (a
  Flax dense [in, out] is a torch [out, in]; an HWIO conv an OIHW one);
- `tp_attention_ok` and `tp_geglu_ok` equal the JAX gates over a grid of
  (dp, tp, B, N, C, F), the JAX meshes `make_mesh_dp_tp` on the 8 virtual
  CPU devices;
- `shard_params_tp` keeps on each rank exactly the matching slice of the
  converted tensor (the GEGLU projection's chunk of the hidden half and
  of the gate half, paired), and every other tensor whole."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.ops.pallas import tp_attention_ok as jax_attention_ok
from d3roma_tpu.ops.pallas.geglu import tp_geglu_ok as jax_geglu_ok
from d3roma_tpu.parallel import make_mesh_dp_tp as jax_mesh
from d3roma_tpu.parallel import pad_batch_to_devices as jax_pad
from d3roma_tpu.parallel import slice_process_local as jax_slice
from d3roma_tpu.parallel import tp_param_specs as jax_specs
from d3roma_tpu.parallel import tp_shard_count as jax_count
from d3roma_tpu_torch.models import AutoencoderKL, UNet2D, UNet2DCondition, flax_unet_to_torch
from d3roma_tpu_torch.models.convert import _torch_component
from d3roma_tpu_torch.ops.kernels import tp_attention_ok, tp_geglu_ok
from d3roma_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    pad_batch_to_devices,
    shard_params_tp,
    slice_process_local,
    tp_param_specs,
    tp_shard_count,
)
from torch_port_utils import TINY_UNET2D, random_flax_tree

TINY_UNET = dict(
    in_channels=12, out_channels=4, block_out_channels=(8, 16),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, attention_head_dim=8, cross_attention_dim=16, norm_groups=4,
)
KERNEL_UNET = dict(TINY_UNET, block_out_channels=(128, 128), attention_head_dim=64,
                   use_flash_attention="pallas-self", fused_ff=True)
TINY_VAE = dict(block_out_channels=(8, 8, 8, 16), latent_channels=4, norm_groups=2)

MODELS = {
    "tiny_unet": (JaxUNet, UNet2DCondition, TINY_UNET,
                  lambda: (jnp.zeros((1, 4, 4, 12)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 4, 16)))),
    "kernel_unet": (JaxUNet, UNet2DCondition, KERNEL_UNET,
                    lambda: (jnp.zeros((1, 16, 32, 12)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 4, 16)))),
    "tiny_vae": (JaxVAE, AutoencoderKL, TINY_VAE, lambda: (jnp.zeros((1, 32, 32, 3)),)),
    "pixel_unet": (JaxUNet2D, UNet2D, TINY_UNET2D,
                   lambda: (jnp.zeros((1, 32, 64, 5)), jnp.zeros((1,), jnp.int32))),
}


def _layout(dp, tp, rank=0):
    return Mesh((DATA_AXIS, MODEL_AXIS), (dp, tp), rank=rank)


def _batch(rows, seed):
    rs = np.random.RandomState(seed)
    return {"x": rs.standard_normal((rows, 3, 2)).astype(np.float32),
            "fxb": rs.uniform(1, 2, (rows,)).astype(np.float32),
            "scalar": np.float32(3.0), "path": [f"p{i}" for i in range(rows)]}


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("rows,devices", [(5, 8), (8, 8), (3, 2), (4, 2), (1, 4), (7, 3)])
def test_pad_and_slice_match_jax(rows, devices):
    batch = _batch(rows, rows * 10 + devices)
    ours, ref = pad_batch_to_devices(batch, devices), jax_pad(batch, devices)
    _same(ours, ref)
    for pc in (1, 2, devices):
        if ours["x"].shape[0] % pc:
            continue
        for pi in range(pc):
            _same(slice_process_local(ours, pi, pc), jax_slice(ref, pi, pc))


def _torch_name(path) -> str:
    names = [k.key for k in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(names[-1], names[-1])
    return ".".join([_torch_component(n) for n in names[:-1]] + [leaf])


def _torch_dim(spec: P, ndim: int):
    """The torch dim a JAX spec shards: HWIO out -> OIHW 0, dense [I, O]
    out -> [O, I] 0, in -> 1."""
    if MODEL_AXIS not in spec:
        return None
    flax_dim = list(spec).index(MODEL_AXIS)
    return {(4, 3): 0, (2, 1): 0, (2, 0): 1}[(ndim, flax_dim)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_tp_param_specs_match_jax(model, tp):
    jax_cls, port_cls, kw, args = MODELS[model]
    shapes = jax.eval_shape(jax_cls(**kw).init, jax.random.PRNGKey(0), *args())["params"]
    jmesh = jax_mesh(8 // tp, tp)
    jspecs = jax_specs(shapes, jmesh)
    ref = {}
    for (path, spec), leaf in zip(
            jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda s: isinstance(s, P))[0],
            jax.tree_util.tree_leaves(shapes)):
        ref[_torch_name(path)] = _torch_dim(spec, leaf.ndim)
    port = port_cls(**kw, device="cpu")
    ours = tp_param_specs(port, _layout(8 // tp, tp))
    assert ours == ref
    assert tp_shard_count(port, _layout(8 // tp, tp)) == jax_count(shapes, jmesh) > 0
    # without a model axis nothing shards, as in JAX
    assert tp_shard_count(port, _layout(8, 1)) == jax_count(shapes, jax_mesh(8, 1)) == 0


GRID = [(dp, tp) for dp in (1, 2, 4, 8) for tp in (1, 2, 4, 8) if dp * tp <= 8]


@pytest.mark.parametrize("dp,tp", GRID)
def test_tp_gates_match_jax(dp, tp):
    jmesh, mesh = jax_mesh(dp, tp), _layout(dp, tp)
    for b in (1, 2, 3, 4, 8):
        for n in (60, 240, 512, 920, 1023, 3600):
            assert tp_attention_ok(mesh, b, n) == jax_attention_ok(jmesh, b, n), (b, n)
        for c, f in ((320, 1280), (640, 2560), (1280, 5120), (128, 512), (24, 96),
                     (320, 1200), (2560, 10240)):
            assert tp_geglu_ok(mesh, c, f, b) == jax_geglu_ok(jmesh, c, f, b), (b, c, f)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_are_slices_of_the_converted_tensors(tp):
    """Each rank's shard of every sharded weight is the converted tensor's
    slice; the GEGLU projection pairs chunk r of each half."""
    args = MODELS["kernel_unet"][3]()
    tree = random_flax_tree(JaxUNet(**KERNEL_UNET), 3, *args)
    full = {k: v.clone() for k, v in flax_unet_to_torch(tree).items()}
    base = UNet2DCondition(**KERNEL_UNET, device="cpu")
    base.load_state_dict(full)
    specs = tp_param_specs(base, _layout(1, tp))
    for rank in range(tp):
        model = shard_params_tp(copy.deepcopy(base), _layout(1, tp, rank))
        local = dict(model.named_parameters())
        assert local.keys() == full.keys()
        for name, t in full.items():
            dim = specs[name]
            if dim is None:
                want = t
            elif name.endswith("net.0.proj.weight"):
                f = t.shape[0] // 2
                want = torch.cat([t[:f].chunk(tp)[rank], t[f:].chunk(tp)[rank]])
            else:
                want = t.chunk(tp, dim)[rank]
            assert torch.equal(local[name].detach(), want), name
        assert model.tp_mesh is not None
