"""Rank bodies of tests/test_torch_train_parallel.py (spawned by
`torch_port_utils.run_ranks`, so this module imports neither jax nor the
JAX package): the port's train step on a ``(data, model)`` mesh of the
world's ranks, and the gradients of single tensor-parallel layers."""

import numpy as np
import torch

from torch_port_utils import ReplayDraws


def _tensors(state: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def train_steps(spec: dict) -> dict:
    """`spec["steps"]` train steps of a tiny model on a ``(dp, tp)`` mesh
    (`spec["mesh"]`; (1, 1) in one process), each rank on its data rank's
    rows of `spec["batch"]`: the step's metrics and the state after the
    last step in the one-process layout (gathered under TP). The draws are
    the global batch's: `spec["draws"][i]` replayed (the JAX step's), else
    a CPU generator seeded 100 + i (+ `spec["first_step"]`, the step a
    resumed run starts at). `spec["load"]` resumes a checkpoint
    before the mesh's cut; `spec["save"]` writes one after the first step.
    """
    from d3roma_tpu_torch.config import TrainingConfig
    from d3roma_tpu_torch.models import AutoencoderKL, UNet2D, UNet2DCondition
    from d3roma_tpu_torch.ops.noise import GeneratorDraws
    from d3roma_tpu_torch.ops.resample import SamplerState
    from d3roma_tpu_torch.parallel import (
        DATA_AXIS, make_mesh_dp_tp, shard_params_tp, shard_state_tp, slice_process_local)
    from d3roma_tpu_torch.training import (
        StepCounter, build_optimizer, create_train_state, load_state, make_train_step,
        save_state)

    cfg = TrainingConfig(**spec["config"])
    dp, tp = spec["mesh"]
    mesh = make_mesh_dp_tp(dp, tp, "cpu")
    unet = (UNet2DCondition if cfg.ldm else UNet2D)(**spec["unet"], remat=True, device="cpu")
    unet.load_state_dict(_tensors(spec["unet_state"]))
    vae = text = None
    if cfg.ldm:
        vae = AutoencoderKL(**spec["vae"], device="cpu").requires_grad_(False)
        vae.load_state_dict(_tensors(spec["vae_state"]))
        text = torch.from_numpy(spec["text"])
    opt = build_optimizer(cfg, 10, list(unet.parameters()))
    state = create_train_state(cfg, unet, 10, optimizer=opt)
    if spec.get("history") is not None:
        hist, cnt = spec["history"]
        state.sampler_state = SamplerState(torch.from_numpy(hist.copy()),
                                           torch.from_numpy(cnt.copy()))
    if spec.get("load"):
        load_state(spec["load"], state)
    if tp > 1:
        shard_state_tp(state, mesh)
        if vae is not None:
            shard_params_tp(vae, mesh)
    step = make_train_step(cfg, unet, opt, cfg.schedule_config(train=True).tables("cpu"),
                           vae=vae, text_embed=text, mesh=mesh if mesh.size > 1 else None)
    rows = slice_process_local(spec["batch"], mesh.coord(DATA_AXIS), dp)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rows.items()}
    metrics = []
    for i in range(spec["steps"]):
        seed = 100 + spec.get("first_step", 0) + i
        draws = (ReplayDraws(spec["draws"][i]) if spec.get("draws") is not None
                 else GeneratorDraws(torch.Generator().manual_seed(seed)))
        metrics.append(_numpy(step(state, batch, draws)))
        if spec.get("save") and i == 0:
            save_state(spec["save"], state, StepCounter(), mesh)
    sharded = [(n, p.shape) for n, p in zip(
        [n for n, _ in unet.named_parameters()], opt.params) if p is not None]
    return {"metrics": metrics, "state": _numpy(state.state_dict()),
            "sharded_leaves": sum(s is not None for s in opt.shards),
            "local_shapes": {n: tuple(s) for n, s in sharded}}


def jobs(todo: dict) -> dict:
    """{name: fn(*args)} for {name: (the name of a function here, args)},
    in order, on the same ranks."""
    return {name: globals()[fn](*args) for name, (fn, args) in todo.items()}


def entry_point(cwd: str, argv: list, max_steps=None) -> dict:
    """`python -m d3roma_tpu_torch.train` on this rank (in `cwd`; `train`
    given `max_steps`): its exit code, whether the rank was outside the
    mesh, and every path it opened for writing or made, renamed or removed
    (an audit hook)."""
    import functools
    import os
    import sys

    from d3roma_tpu_torch import train, training
    from d3roma_tpu_torch.training import train_loop

    wrote, idle = [], []

    def hook(event, args):
        if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
            wrote.append(str(args[0]))
        elif event in ("os.mkdir", "os.rename", "os.remove"):
            wrote.append(str(args[0]))

    run = train_loop._train

    def recorded(*args):
        out = run(*args)
        idle.append(out[0] is None)
        return out

    train_loop._train = recorded
    training.train = functools.partial(training.train, max_steps=max_steps)
    os.chdir(cwd)
    sys.addaudithook(hook)
    code = train.main(argv)
    return {"code": code, "idle": idle == [True], "wrote": wrote}


def layer_grads(seed: int) -> dict:
    """Each tensor-parallel layer kind on a (1, 2) mesh against the same
    layer unsharded, under one loss: {kind: {"ours": {name: this rank's
    weight or bias gradient, "x": the input's gradient, "y": the output},
    "ref": the same of the unsharded layer, the weights' cut to this
    rank's shard}}."""
    from d3roma_tpu_torch.models.layers import GEGLU, Conv2d, FeedForward, Linear
    from d3roma_tpu_torch.parallel import layer_shards, make_mesh_dp_tp, shard_params_tp

    mesh = make_mesh_dp_tp(1, 2, "cpu")
    gen = torch.Generator().manual_seed(seed)

    class Site(torch.nn.Module):
        """A layer under the name the rules read (`name` dotted through
        module lists)."""

        def __init__(self, name, layer):
            super().__init__()
            self.path = name.split(".")
            mod = self
            for i, part in enumerate(self.path[:-1]):
                child = (torch.nn.ModuleList() if self.path[i + 1].isdigit()
                         else torch.nn.Module())
                mod.add_module(part, child) if not part.isdigit() else mod.append(child)
                mod = child
            mod.add_module(self.path[-1], layer) if not self.path[-1].isdigit() else \
                mod.append(layer)

        def forward(self, x):
            mod = self
            for part in self.path:
                mod = mod[int(part)] if part.isdigit() else getattr(mod, part)
            return mod(x)

    layers = {
        "column dense": (lambda: Site("to_q", Linear(16, 12)), (3, 5, 16)),
        "row dense": (lambda: Site("to_out.0", Linear(16, 12)), (3, 5, 16)),
        "conv": (lambda: Site("conv1", Conv2d(6, 8, 3, padding=1)), (2, 5, 7, 6)),
        "GEGLU projection (gathered)": (lambda: Site("net.0", GEGLU(16, 32)), (3, 5, 16)),
        "feed-forward (paired chunks)": (lambda: Site("ff", FeedForward(16)), (3, 5, 16)),
    }
    out = {}
    for kind, (make, shape) in layers.items():
        torch.manual_seed(seed)
        whole, sharded = make(), make()
        with torch.no_grad():
            for p in whole.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        sharded.load_state_dict(whole.state_dict())
        shard_params_tp(sharded, mesh)
        x = torch.randn(shape, generator=gen)
        res = {}
        for name, layer in (("ref", whole), ("ours", sharded)):
            xi = x.clone().requires_grad_(True)
            y = layer(xi)
            w = torch.sin(torch.arange(y.numel(), dtype=torch.float32)).reshape(y.shape)
            (y * w).sum().backward()
            res[name] = {"x": xi.grad.numpy(), "y": y.detach().numpy()}
            res[name].update({n: p.grad.numpy().copy() for n, p in layer.named_parameters()})
        cut = layer_shards(sharded)
        for n, shard in cut.items():
            res["ref"][n] = shard.take(torch.from_numpy(res["ref"][n])).numpy()
        res["sharded"] = sorted(cut)
        out[kind] = res
    return out


# Adafactor over whole parameters: torch-layout shapes, the dim each is cut
# along (None: replicated), paired (the GEGLU projection's halves). Their
# Flax views put the cut dim at every place the factoring cares about: the
# averaged-away largest axis, the second-largest, neither, and unfactored.
ADAFACTOR_PARAMS = (
    ((256, 192), 0, False),  # Flax [192, 256]: cut the largest axis (v_row whole)
    ((192, 256), 0, False),  # Flax [256, 192]: cut the second largest (v_col whole)
    ((128, 256, 3, 3), 0, False),  # HWIO (3, 3, 256, 128): cut the second largest
    ((4, 3, 256, 128), 0, False),  # Flax (256, 128, 3, 4): cut neither factored axis
    ((512, 128), 0, True),  # the GEGLU projection [hidden | gate], chunk r of each half
    ((192, 256), 1, False),  # a row-parallel dense: Flax [256, 192], cut the largest
    ((8, 6), 0, False),  # unfactored: the second moment whole-shaped, cut
    ((256,), None, False),  # a replicated bias
)


def adafactor_shards(seed: int, steps: int) -> dict:
    """ChainOptimizer(adafactor, clip 1) over ADAFACTOR_PARAMS: in one
    process on the whole tensors, and on a (1, 2) mesh on this rank's
    shards (`shard_`), `steps` steps of the same gradients, then one step
    whose gradient is NaN in rank 1's shard of the first parameter only:
    (whole params after each step and the global norms, and the same from
    the shards, gathered; the state gathered)."""
    from d3roma_tpu_torch.parallel import TPShard, make_mesh_dp_tp
    from d3roma_tpu_torch.parallel.tensor import whole_tensors
    from d3roma_tpu_torch.training.state import ChainOptimizer, constant_schedule

    mesh = make_mesh_dp_tp(1, 2, "cpu")
    gen = torch.Generator().manual_seed(seed)
    whole = [torch.randn(shape, generator=gen) for shape, _, _ in ADAFACTOR_PARAMS]
    grads = [[torch.randn(shape, generator=gen) * 0.1 for shape, _, _ in ADAFACTOR_PARAMS]
             for _ in range(steps + 1)]
    shards = [None if d is None else TPShard(mesh, d, paired) for _, d, paired in ADAFACTOR_PARAMS]
    grads[steps][0][-1, 0] = float("nan")  # in the last rows: rank 1's shard

    def run(params, cut):
        opt = ChainOptimizer(params, constant_schedule(1e-2), "adafactor", clip_grad_norm=1.0)
        if cut:
            local = [p if sh is None else sh.take(p).clone() for p, sh in zip(params, shards)]
            opt.shard_(mesh, local, shards)
        out = []
        for g in grads:
            g = [x if not cut or sh is None else sh.take(x) for x, sh in zip(g, shards)]
            norm, finite = opt.norm_and_finite(g)
            opt.step(g, norm, finite)
            ps = whole_tensors(list(zip(opt.params, shards if cut else [None] * len(shards))))
            out.append((_numpy(ps), float(norm), bool(finite)))
        return out, _numpy(opt.state_dict(whole=True))

    ref = run([p.clone() for p in whole], False)
    ours = run([p.clone() for p in whole], True)
    return {"ref": ref, "ours": ours}
