"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
the tiny model configuration both packages build, numpy-seeded weights, and
conversions between torch and numpy."""

import numpy as np
import torch

# One intra-op thread per test process. The suite runs under pytest-xdist,
# several worker processes on the machine's cores; each PyTorch process
# would otherwise keep a pool of one OpenMP thread per core, and the pools
# of the workers, waiting on tiny tensors' ops, take the cores from one
# another (the port's slowest test files ran 3-4x longer that way). Every
# test module is collected in every worker, so this holds for all of them.
torch.set_num_threads(1)

# The slice's models at a tiny width. A 32x64 image gives a 16x32 latent =
# 512 tokens, so the top UNet level takes the attention kernel in both
# packages (>= 512 keys), and every transformer block the fused GEGLU
# (F = 4C is a multiple of 128).
TINY_UNET = dict(
    in_channels=12, out_channels=4, block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, attention_head_dim=32, cross_attention_dim=16,
    norm_groups=8, use_flash_attention="pallas-self", fused_ff=True,
)
# Three levels, so the DeepCache shallow pass can run at depth 1 and 2 (the
# bench default's depth); the 512-token level is the only kernel level.
TINY_UNET3 = dict(
    TINY_UNET, block_out_channels=(32, 64, 64),
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
)
TINY_VAE = dict(block_out_channels=(32, 64), norm_groups=8)
IMAGE_HW = (32, 64)

# the bench's sampler schedule (SD2.1: v-prediction, scaled-linear betas,
# leading spacing with steps_offset 1)
SCHEDULE = dict(
    num_train_timesteps=1000, beta_schedule="scaled_linear", beta_start=0.00085,
    beta_end=0.012, prediction_type="v_prediction", clip_sample=False,
    timestep_spacing="leading", steps_offset=1,
)


def randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter from numpy.random.RandomState(seed): weights of
    rank >= 2 from N(0, 1/fan_in), norm weights 1 + N(0, 0.1), biases
    N(0, 0.1) — no parameter keeps a default value, so a mis-mapped bias or
    norm scale shows in the outputs."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            shape = tuple(p.shape)
            if p.ndim >= 2:
                val = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif name.endswith("weight"):
                val = 1.0 + 0.1 * rs.standard_normal(shape)
            else:
                val = 0.1 * rs.standard_normal(shape)
            p.copy_(torch.from_numpy(val.astype(np.float32)))
    return module


def state_dict_numpy(module: torch.nn.Module) -> dict:
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


# The pixel UNet of tests/test_pipelines.py: two levels, the second with
# self-attention (head dim 8), one layer a block, 8 groups; RGB + raw.
TINY_UNET2D = dict(
    in_channels=5, out_channels=1, block_out_channels=(16, 32),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_groups=8,
)
# the JAX bench's pixel sampler schedule
PIXEL_SCHEDULE = dict(num_train_timesteps=128, beta_schedule="squaredcos_cap_v2",
                      prediction_type="sample", clip_sample=True)


def jax_noise_schedule(key, shape, steps: int):
    """The noise the JAX package's sampling draws from `key`: the initial
    noise (`split(key)`, its second key) and each step's sampling noise
    (`split(k, 3)` per step, its second key), fp32 numpy."""
    import jax

    key, k_init = jax.random.split(key)
    x_init = np.array(jax.random.normal(k_init, shape, np.float32))
    noises = []
    for _ in range(steps):
        key, k_noise, _ = jax.random.split(key, 3)
        noises.append(np.array(jax.random.normal(k_noise, shape, np.float32)))
    return x_init, noises


def random_flax_tree(module, seed: int, *args):
    """The param tree of a JAX module with every leaf drawn from
    numpy.random.RandomState(seed) (Flax init leaves biases at 0 and norm
    scales at 1, which would hide a swapped pair): N(0, 1/fan_in) for
    kernels, 1 + N(0, 0.1) for scales, N(0, 0.1) otherwise."""
    import jax

    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rs = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rs.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        base = 1.0 if leaf == "scale" else 0.0
        return (base + 0.1 * rs.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


class ReplayDraws:
    """Stands in for the port's train-step draws (`ops/noise.py`'s
    GeneratorDraws): each call returns the next array of a list, made by
    the JAX package from its keys, after checking its shape."""

    def __init__(self, arrays):
        self.arrays = [np.asarray(a) for a in arrays]

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(np.array(a))

    def normal(self, shape, dtype=torch.float32):
        return self._next(shape).to(dtype)

    def randint(self, low, high, n):
        return self._next((n,)).long()

    def categorical(self, probs, n):
        return self._next((n,)).long()


def jax_pyramid_draws(key, shape):
    """The normals `pyramid_noise_like(key, shape)` draws, in order."""
    import jax

    b, h, w, c = shape
    keys = jax.random.split(key, 11)
    out = [np.array(jax.random.normal(keys[0], shape, np.float32))]
    for i in range(1, 11):
        hh, ww = max(1, h // (2**i)), max(1, w // (2**i))
        out.append(np.array(jax.random.normal(keys[i], (b, hh, ww, c), np.float32)))
        if hh == 1 or ww == 1:
            break
    return out


def jax_step_draws(key, noise_shape, strategy, bs, T, t_probs=None, rgb_shape=None):
    """The JAX train step's draws from its key (`split(key, 3)`: the noise,
    the timesteps — uniform, or categorical over `t_probs` — then the RGB
    condition's noise when `rgb_shape` is given), in the port's call order."""
    import jax
    import jax.numpy as jnp

    k_noise, k_t, k_rgb = jax.random.split(key, 3)
    if strategy == "pyramid":
        out = jax_pyramid_draws(k_noise, noise_shape)
    else:
        out = [np.array(jax.random.normal(k_noise, noise_shape, np.float32))]
    if t_probs is None:
        out.append(np.array(jax.random.randint(k_t, (bs,), 0, T)))
    else:
        logits = jnp.log(jnp.maximum(jnp.asarray(t_probs), 1e-20))
        out.append(np.array(jax.random.categorical(k_t, logits, shape=(bs,))))
    if rgb_shape is not None:
        out.append(np.array(jax.random.normal(k_rgb, rgb_shape, np.float32)))
    return out


class JaxKeyDraws:
    """The JAX train step's draws from its key, made on demand in the
    port's call order: `split(key, 3)` gives the noise key (split again in
    11 for the pyramid's levels), the timesteps' key and the RGB noise's
    key; normals asked for before the timesteps are the noise's, after them
    the RGB condition's."""

    def __init__(self, key, strategy: str):
        import jax

        self.k_noise, self.k_t, self.k_rgb = jax.random.split(key, 3)
        self.noise_keys = (list(jax.random.split(self.k_noise, 11)) if strategy == "pyramid"
                           else [self.k_noise])
        self.t_drawn = False

    def normal(self, shape, dtype=torch.float32):
        import jax

        key = self.k_rgb if self.t_drawn else self.noise_keys.pop(0)
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), np.float32)))

    def randint(self, low, high, n):
        import jax

        self.t_drawn = True
        return torch.from_numpy(np.array(jax.random.randint(self.k_t, (n,), low, high))).long()

    def categorical(self, probs, n):
        import jax
        import jax.numpy as jnp

        self.t_drawn = True
        logits = jnp.log(jnp.maximum(jnp.asarray(probs.numpy()), 1e-20))
        return torch.from_numpy(np.array(jax.random.categorical(self.k_t, logits,
                                                                shape=(n,)))).long()


# ---------------------------------------------------------------------- #
# tensor-parallel tests: ranks in spawned processes on the CPU
# ---------------------------------------------------------------------- #


def _rank_main(rank: int, world: int, tmp: str, fn, args) -> None:
    """One rank: join the gloo group of a file:// store, run fn(*args), keep
    its value (or its traceback) in tmp/rank<r>.pt."""
    import os
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                               rank=rank, world_size=world)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save({"value": value}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)


def run_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """fn(*args) on `world` ranks of a gloo process group, each a spawned
    process on the CPU (fn and args picklable: fn a module-level function of
    a module that imports neither jax nor the JAX package); the ranks'
    return values, in rank order."""
    import multiprocessing as mp
    import os
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {world} left no result (exit code "
                                   f"{procs[r].exitcode})")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise RuntimeError(f"rank {r} of {world} failed:\n{res['error']}")
            results.append(res["value"])
    return results


def _tp2():
    from d3roma_tpu_torch.parallel import make_mesh_dp_tp

    return make_mesh_dp_tp(1, 2, "cpu")


def tp_attention_ranks(q, k, v):
    """Rank body: `mha_attention_tp` and its plain version, bf16 route and
    int8, on numpy q, k, v (a (1, 2) mesh)."""
    from d3roma_tpu_torch.ops.kernels import mha_attention_tp, mha_attention_tp_plain

    from d3roma_tpu_torch.parallel import broadcast_object, replicate_state

    mesh = _tp2()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = {quant: (mha_attention_tp(*t, mesh, quant=quant if quant == "int8" else None).numpy(),
                   mha_attention_tp_plain(*t, mesh, quant=quant if quant == "int8" else None)
                   .numpy())
           for quant in ("bf16", "int8")}
    # rank 0's state and objects on every rank
    mine = {"w": torch.full((3,), float(mesh.rank)), "i": torch.arange(2) + mesh.rank}
    replicate_state(mine, mesh)
    out["replicated"] = ({k: v.numpy() for k, v in mine.items()},
                        broadcast_object({"rank": mesh.rank}, mesh))
    return out


def tp_geglu_ranks(x, w1h, w1g, w2, b1h, b1g, b2, act_scale):
    """Rank body: `geglu_ff_tp` and its plain version, float and static
    int8, each rank on its F chunk of the JAX-layout weights (W1 [C, F]
    by columns, W2 [F, C] by rows), the int8 operands quantized from the
    chunk as FeedForward makes them."""
    from d3roma_tpu_torch.models.layers import FeedForward
    from d3roma_tpu_torch.ops.kernels import geglu_ff_tp, geglu_ff_tp_plain

    mesh = _tp2()
    r = mesh.coord("model")
    t = {k: torch.from_numpy(a) for k, a in dict(x=x, w1h=w1h, w1g=w1g, w2=w2, b1h=b1h,
                                                 b1g=b1g, b2=b2).items()}
    w1h_r, w1g_r = (t[k].chunk(2, 1)[r] for k in ("w1h", "w1g"))
    w2_r = t["w2"].chunk(2, 0)[r]
    b1h_r, b1g_r = (t[k].chunk(2)[r] for k in ("b1h", "b1g"))
    chunk = (w1h_r, w1g_r, w2_r, b1h_r, b1g_r)
    ops = FeedForward._make_int8_operands(w1h_r.t(), w1g_r.t(), w2_r.t(), b1h_r, b1g_r,
                                          t["b2"])
    return {"float": (geglu_ff_tp(t["x"], chunk, t["b2"], mesh).numpy(),
                      geglu_ff_tp_plain(t["x"], chunk, t["b2"], mesh).numpy()),
            "int8": (geglu_ff_tp(t["x"], ops[:8], ops[8], mesh, act_scale).numpy(),
                     geglu_ff_tp_plain(t["x"], ops[:8], ops[8], mesh, act_scale).numpy())}


def _launches():
    from d3roma_tpu_torch.ops.kernels import (
        geglu_ff, geglu_ff_int8, geglu_ff_tp, mha_attention, mha_attention_int8,
        mha_attention_tp)

    return {f.__name__: f.launches for f in (mha_attention_tp, geglu_ff_tp, mha_attention,
                                            mha_attention_int8, geglu_ff, geglu_ff_int8)}


def tp_unet_ranks(kw, state, lat, t, ctx):
    """Rank body: the port's UNet2DCondition(**kw) with `state` (numpy),
    sharded over a (1, 2) mesh, on numpy inputs; (output, launches a
    forward)."""
    from d3roma_tpu_torch.models import UNet2DCondition
    from d3roma_tpu_torch.parallel import shard_params_tp

    unet = UNet2DCondition(**kw, device="cpu")
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    shard_params_tp(unet, _tp2())
    before = _launches()
    with torch.no_grad():
        out = unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    return out.numpy(), {k: v - before[k] for k, v in _launches().items()}


def tp_vae_encode_ranks(kw, state, x, quant):
    """Rank body: the port's AutoencoderKL(**kw) with `state`, in the int8
    mode `quant`: (encode(x).mean unsharded, the same sharded over a (1, 2)
    mesh, the sharded encode's launches)."""
    from d3roma_tpu_torch.models import AutoencoderKL
    from d3roma_tpu_torch.parallel import shard_params_tp

    vae = AutoencoderKL(**kw, device="cpu")
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    vae.set_quant(quant)
    with torch.no_grad():
        whole = vae.encode(torch.from_numpy(x)).mean
        shard_params_tp(vae, _tp2())
        before = _launches()
        out = vae.encode(torch.from_numpy(x)).mean
    return whole.numpy(), out.numpy(), {k: v - before[k] for k, v in _launches().items()}


class ReplayNoise:
    """The port's pipeline drawing given noise: each call takes the next
    (initial latents, [step noise, ...]) of numpy arrays."""

    def __init__(self, pipe, draws):
        self.pipe, self.draws = pipe, list(draws)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        x_init, noise = self.draws.pop(0)
        return self.pipe(latents=torch.from_numpy(x_init),
                         step_noise=[torch.from_numpy(n) for n in noise], **kw)


def tp_d3roma_ranks(overrides, pipeline_dir, draws, frames):
    """Rank body: the port's rgb+raw `D3RoMa` at task.tensor_parallel 1 and
    2 (on the CPU) on the pipeline directory with the whole-row attention
    and fused GEGLU routes on, each replaying `draws`, on `frames` [(rgb,
    raw), ...]; ({tp: [depth, ...]}, the tp=2 run's launches, {tp: the
    parameter bytes a rank holds})."""
    from d3roma_tpu_torch.inference import D3RoMa
    from d3roma_tpu_torch.parallel import param_bytes
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline
    from d3roma_tpu_torch.utils.camera import Realsense

    depths, nbytes = {}, {}
    for tp in (1, 2):
        pipe = GuidedLatentDiffusionPipeline.from_pretrained(pipeline_dir, device="cpu")
        pipe.unet.set_kernels(use_flash_attention="pallas-self", fused_ff=True)
        d = D3RoMa(list(overrides) + [f"task.tensor_parallel={tp}"],
                   Realsense.default_real("fxm"), variant="rgb+raw", pipeline=pipe,
                   device="cpu")
        nbytes[tp] = param_bytes(d.pipeline.unet) + param_bytes(d.pipeline.vae)
        d.pipeline = ReplayNoise(d.pipeline, draws)
        before = _launches()
        depths[tp] = [d.infer_with_rgb_raw(rgb, raw) for rgb, raw in frames]
    return depths, {k: v - before[k] for k, v in _launches().items()}, nbytes


class ReplayPixelNoise:
    """The port's pixel pipeline drawing given noise: each call takes the
    next (x_init, [step noise, ...]) of numpy arrays."""

    def __init__(self, pipe, draws):
        self.pipe, self.draws = pipe, list(draws)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        x_init, noise = self.draws.pop(0)
        return self.pipe(x_init=torch.from_numpy(x_init),
                         step_noise=[torch.from_numpy(n) for n in noise], **kw)


def dp_eval_ranks(config_kw, pipeline_dir, raw, x_init, noise):
    """Rank body: the port's data-parallel `evaluate_dataset` over the
    world's ranks (a 1-D data mesh) on one host batch `raw`, padded to the
    mesh, each rank on its rows, replaying its rows of the whole batch's
    noise; (metrics, the averaged samples' epe, sample count)."""
    from d3roma_tpu_torch.config import TrainingConfig
    from d3roma_tpu_torch.evaluation import evaluate_dataset
    from d3roma_tpu_torch.parallel import (
        DATA_AXIS, all_gather_cat, make_mesh, pad_batch_to_devices, shard_batch,
        slice_process_local)
    from d3roma_tpu_torch.pipelines import GuidedDiffusionPipeline

    cfg = TrainingConfig(**config_kw)
    mesh = make_mesh("cpu")
    n, i = mesh.axis_sizes[DATA_AXIS], mesh.coord(DATA_AXIS)
    pipe = GuidedDiffusionPipeline.from_pretrained(pipeline_dir, device="cpu")
    per = x_init.shape[0] // n
    rows = slice(i * per, (i + 1) * per)
    pipe = ReplayPixelNoise(pipe, [(x_init[rows], [a[rows] for a in noise])])

    def prep(b):
        return shard_batch(slice_process_local(pad_batch_to_devices(b, n), i, n), mesh)

    def gather_rows(a):
        return all_gather_cat(torch.as_tensor(a), mesh, DATA_AXIS, 0).numpy()

    metrics, stat = evaluate_dataset(cfg, pipe, [raw], torch.Generator().manual_seed(0),
                                     preprocess=prep, max_batches=1, gather_rows=gather_rows)
    return metrics, list(stat._recent["epe"]), len(stat)
