"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
the tiny model configuration both packages build, numpy-seeded weights, and
conversions between torch and numpy."""

import numpy as np
import torch

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
