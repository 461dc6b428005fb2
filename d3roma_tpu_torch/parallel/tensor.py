"""Tensor parallelism: shard the model over the second axis of a mesh.

Port of `d3roma_tpu/parallel/tensor.py`. The JAX package annotates the
parameters with PartitionSpecs and lets jit's partitioner insert every
collective. Here each rank keeps only its shard of a sharded weight
(`shard_params_tp`), and the layer holding it (`models/layers.py`'s
`Linear` and `Conv2d`, through their `tp_shard`) computes with it:

- a column-parallel dense (output features sharded) or a conv (output
  channels sharded) computes its slice of the output, then gathers it
  along the model axis, so the activations stay replicated;
- a row-parallel dense (input features sharded: `to_out`, `net_2`,
  `proj_out`) takes its slice of the replicated input and all-reduces the
  partial products, then adds its bias once. Under static int8 its weight
  scale is the absmax over all of its input features (the global scale
  the JAX partitioner computes), not over the shard's.

The rules are the JAX package's, over the port's diffusers names (through
`models/convert.py`'s name map): a Flax dense [in, out] is a torch
[out, in], so column-parallel shards dim 0 and row-parallel dim 1; a conv's
output channels are OIHW dim 0. A dimension that does not divide tp stays
replicated; so do the biases and norms (each rank holds them whole). The
feed-forward's `net.0.proj` is sharded as the GEGLU composition needs it
(`ops/kernels/geglu.py::geglu_ff_tp`): rank r holds chunk r of the hidden
half's rows and chunk r of the gate half's, one [2F/tp, C] block; its
gather puts the halves back in order.

`shard_pipeline_tp` also sets `tp_mesh` on the UNet and the VAE, which
routes their kernel sites through the tensor-parallel compositions
(`mha_attention_tp`, `geglu_ff_tp`) where the gates admit them, and to the
plain path where not; the fused self-attention and the flash route are off
under a mesh, as in the JAX package.

Training: the gather and the sum carry gradients (`parallel/mesh.py`'s
`gather_along`, `sum_along`), and a sharded layer's replicated input goes
through `copy_along`, whose backward sums the ranks' parts of the input's
gradient; so each rank gets exactly its slice of the whole weight's
gradient, and every replicated tensor the whole gradient.
`shard_state_tp` cuts a train state (the model's parameters and the
optimizer's moments, by the same rules); `gather_params_tp` and the
optimizer's `state_dict` give the one-process layout back, for checkpoints
and exports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from d3roma_tpu_torch.device import DeviceLike
from d3roma_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    GRAD_BUCKET_BYTES,
    Mesh,
    _world,
    all_gather_cat,
    all_reduce,
    build_mesh,
    copy_along,
    gather_along,
    sum_along,
)

MODEL_AXIS = "model"

_ROW_PARALLEL_NAMES = ("to_out", "net_2", "proj_out")
# the int8 modes whose routing reads only x and the per-output-channel
# weight scales, so that a shard computes what the whole layer would
TP_QUANT_MODES = (False, "static")


def make_mesh_dp_tp(dp: int, tp: int, device: DeviceLike = None,
                    allow_idle: bool = False) -> Optional[Mesh]:
    """The 2-D ``(data, model)`` mesh of the world's dp * tp ranks: rank
    d * tp + m is (d, m), so the ranks of one model group are adjacent.
    With `allow_idle` the world may hold more ranks: those get None."""
    return build_mesh((dp, tp), (DATA_AXIS, MODEL_AXIS), device, allow_idle)


def _leaf_dim(name: str, shape: Tuple[int, ...], tp: int) -> Optional[int]:
    """The JAX package's `_leaf_spec` on the Flax path of a state-dict name:
    the torch dim sharded over the model axis, or None (replicated)."""
    from d3roma_tpu_torch.models.convert import flax_path

    names = flax_path(name)
    if names[-1] != "weight":
        return None
    if len(shape) == 4:
        return 0 if shape[0] % tp == 0 else None
    if len(shape) == 2:
        if any(n in _ROW_PARALLEL_NAMES for n in names):
            return 1 if shape[1] % tp == 0 else None
        return 0 if shape[0] % tp == 0 else None
    return None


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(v.shape) for k, v in params.items()}


def _tp(mesh: Mesh) -> int:
    return mesh.axis_sizes.get(MODEL_AXIS, 1)


def tp_param_specs(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                   mesh: Mesh) -> Dict[str, Optional[int]]:
    """{state-dict name: the dim sharded over the model axis, or None} of a
    model (or a state dict); all None without a model axis of more than one
    rank."""
    tp = _tp(mesh)
    shapes = _named_shapes(params)
    if tp == 1:
        return {k: None for k in shapes}
    return {k: _leaf_dim(k, s, tp) for k, s in shapes.items()}


def tp_shard_count(params, mesh: Mesh) -> int:
    """Number of leaves actually sharded on the model axis (a mesh/model
    mismatch that silently replicates everything shows up as 0)."""
    return sum(d is not None for d in tp_param_specs(params, mesh).values())


def _paired(name: str) -> bool:
    """The feed-forward's GEGLU projection: [hidden | gate] rows."""
    return name.endswith("net.0.proj.weight")


@dataclass(eq=False)
class TPShard:
    """How a Linear or Conv2d holds its shard: `dim` 0 (output features or
    channels) or 1 (input features), `paired` for the GEGLU projection
    (chunk r of each half)."""
    mesh: Mesh
    dim: int
    paired: bool = False

    @property
    def tp(self) -> int:
        return _tp(self.mesh)

    @property
    def index(self) -> int:
        return self.mesh.coord(MODEL_AXIS)

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Chunk `index` of tp of t along `dim` (a view)."""
        return t.chunk(self.tp, dim)[self.index]

    def take(self, t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """This rank's part of a whole tensor along `dim` (the sharded dim by
        default): its chunk, or its chunk of each half when paired."""
        dim = self.dim if dim is None else dim
        if self.paired:
            return torch.cat([self.part(h, dim) for h in t.chunk(2, dim)], dim)
        return self.part(t, dim)

    def local_bias(self, bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The bias a shard adds to its output: its slice under column
        parallelism, none under row parallelism (added after the sum). The
        whole bias is replicated: under autograd its gradient is the sum of
        the ranks' slices'."""
        if bias is None or self.dim == 1:
            return None
        return self.take(copy_along(bias, self.mesh, MODEL_AXIS), 0)

    def copy_input(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated input of a column-parallel layer: its gradient
        is the sum of the ranks' parts."""
        return copy_along(x, self.mesh, MODEL_AXIS)

    def input_slice(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel shard's slice of the replicated input [..., K]
        (the other ranks fill the rest of its gradient)."""
        return self.part(self.copy_input(x), -1)

    def combine(self, y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The whole output from this rank's part: the gather of the
        output-feature slices along the last dim (the halves of a paired
        projection in order), or the sum of the partial products plus the
        bias. Both carry gradients: the gather's backward takes this rank's
        slice (the paired reorder undone by autograd), the sum's passes the
        output's gradient to every rank."""
        if self.dim == 1:
            y = sum_along(y, self.mesh, MODEL_AXIS)
            return y if bias is None else y + bias.to(y.dtype)
        if not self.paired:
            return gather_along(y, self.mesh, MODEL_AXIS, -1)
        g = gather_along(y.unsqueeze(-2), self.mesh, MODEL_AXIS, -2)  # [..., tp, 2 f]
        g = g.unflatten(-1, (2, -1)).transpose(-3, -2)  # [..., 2, tp, f]
        return g.flatten(-3)

    def weight_absmax(self, w: torch.Tensor) -> torch.Tensor:
        """Per output row, the absmax of the whole weight (fp32), from the
        shards' (a row-parallel dense's static int8 scale)."""
        m = w.detach().float().abs().amax(dim=tuple(range(1, w.ndim)))
        return all_reduce(m, self.mesh, MODEL_AXIS, "max")

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's part, in rank order: the
        inverse of `take`."""
        if self.paired:
            halves = [p.chunk(2, self.dim) for p in parts]
            parts = [h[0] for h in halves] + [h[1] for h in halves]
        return torch.cat(list(parts), self.dim)


def whole_tensors(items: Sequence[Tuple[torch.Tensor, Optional[TPShard]]],
                  out_device: DeviceLike = None) -> List[torch.Tensor]:
    """The whole tensor of each (this rank's part, the TPShard it was cut
    by) on `out_device` (each part's own by default), a tensor without a
    shard as it is: the parts flattened into buckets of about
    GRAD_BUCKET_BYTES of one dtype, one all-gather a bucket. Every rank of the
    model axis must call it with the same items."""
    out: List[Optional[torch.Tensor]] = [None] * len(items)

    def flush(idx):
        shard = items[idx[0]][1]
        flat = torch.cat([items[i][0].detach().reshape(-1) for i in idx])
        ranks = all_gather_cat(flat, shard.mesh, MODEL_AXIS, 0, out_device).chunk(shard.tp)
        offset = 0
        for i in idx:
            t, sh = items[i]
            k = t.numel()
            out[i] = sh.join([r[offset:offset + k].view(t.shape) for r in ranks])
            offset += k

    buckets: Dict[torch.dtype, list] = {}
    for i, (t, sh) in enumerate(items):
        if sh is None:
            out[i] = t.detach() if out_device is None else t.detach().to(out_device)
            continue
        idx, size = buckets.get(t.dtype, ([], 0))
        idx.append(i)
        size += t.numel() * t.element_size()
        if size >= GRAD_BUCKET_BYTES:
            flush(idx)
            idx, size = [], 0
        buckets[t.dtype] = (idx, size)
    for idx, _ in buckets.values():
        if idx:
            flush(idx)
    return out


def shard_params_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut every weight `tp_param_specs` shards to this rank's shard, in
    place (the rest stays whole), give its layer the `TPShard` it computes
    with, and set `tp_mesh` on the model and its kernel sites. Returns the
    model."""
    from d3roma_tpu_torch.models.layers import Conv2d, Linear, set_tp_mesh

    specs = tp_param_specs(model, mesh)
    modules = dict(model.named_modules())
    for name, dim in specs.items():
        if dim is None:
            continue
        mod_name, leaf = name.rsplit(".", 1)
        mod = modules[mod_name]
        if not isinstance(mod, (Linear, Conv2d)):
            raise TypeError(f"{name}: a {type(mod).__name__} cannot compute with a shard")
        p = getattr(mod, leaf)
        shard = TPShard(mesh, dim, paired=_paired(name))
        with torch.no_grad():
            local = shard.take(p.detach()).clone(memory_format=torch.contiguous_format)
        setattr(mod, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
        mod.tp_shard = shard
    set_tp_mesh(model, mesh)
    model.tp_mesh = mesh
    return model


def layer_shards(model: nn.Module) -> Dict[str, TPShard]:
    """{parameter name: the TPShard it is cut by} of a sharded model's
    sharded weights (a layer's bias stays whole)."""
    return {f"{name}.weight" if name else "weight": m.tp_shard
            for name, m in model.named_modules() if getattr(m, "tp_shard", None) is not None}


def gather_params_tp(model: nn.Module, out_device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The state dict an unsharded model would have, from a sharded one,
    on `out_device` (each tensor's own by default). Every rank of the model
    axis must call it."""
    shards = layer_shards(model)
    state = model.state_dict()
    return dict(zip(state, whole_tensors([(t, shards.get(n)) for n, t in state.items()],
                                         out_device)))


def shard_state_tp(state, mesh: Mesh):
    """TP-shard a whole train state consistently, in place: the model's
    parameters by the rules (`shard_params_tp`) and the optimizer's
    moments by the same cuts, so a rank keeps only its shards of both.
    Returns the state."""
    model, opt = state.model, state.optimizer
    assert tp_shard_count(model, mesh) > 0, (
        "tensor_parallel set but no param dim divides it — check block_out_channels vs "
        "tensor_parallel")
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for p in opt.params]
    shard_params_tp(model, mesh)
    params = dict(model.named_parameters())
    shards = layer_shards(model)
    opt.shard_(mesh, [params[n] for n in order], [shards.get(n) for n in order])
    return state


def param_bytes(model: nn.Module, whole: bool = False) -> int:
    """The bytes of a model's parameters as this rank holds them, or, with
    `whole`, as an unsharded model holds them (each shard times tp)."""
    total = 0
    for m in model.modules():
        tp = getattr(m, "tp_shard", None)
        for name, p in m.named_parameters(recurse=False):
            n = p.numel() * p.element_size()
            total += n * tp.tp if whole and tp is not None and name == "weight" else n
    return total


def shard_pipeline_tp(pipeline, tp: int, log=None):
    """TP-shard a latent pipeline's UNet and VAE for serving or evaluation.

    Builds the ``(data, model)`` mesh over the world (tp must divide it),
    checks that the rules engage (`tp_shard_count` of the UNet > 0), shards
    both models' parameters, sets `tp_mesh` on them and returns
    (pipeline, mesh), the pipeline changed in place. Calibrate static int8
    AFTER this (the kernel gates, which consult the mesh, decide the scale
    call order)."""
    _, world, _ = _world()
    if world % tp:
        raise ValueError(f"tensor_parallel={tp} must divide the world's {world} ranks")
    mesh = make_mesh_dp_tp(world // tp, tp, pipeline.device)
    assert tp_shard_count(pipeline.unet, mesh) > 0, (
        "tensor_parallel set but no UNet param dim divides it")
    models = [pipeline.unet] + ([pipeline.vae] if getattr(pipeline, "vae", None) is not None
                                else [])
    for m in models:
        bad = {getattr(s, "quant", False) for s in m.modules()} - set(TP_QUANT_MODES)
        if bad:
            raise NotImplementedError(
                f"tensor parallelism runs the int8 modes {TP_QUANT_MODES}, not {sorted(map(str, bad))}"
                f" (ROADMAP.md §1 item 10)")
        shard_params_tp(m, mesh)
    if log is not None:
        log.info("mesh: DP%d x TP%d", world // tp, tp)
    return pipeline, mesh
