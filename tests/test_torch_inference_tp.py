"""The port's `D3RoMa` with `task.tensor_parallel=2` (two spawned ranks of
a gloo group on the CPU) on the tiny latent rgb+raw pipeline of
tests/test_torch_inference.py (TINY_UNET, TINY_VAE, fp32, a directory the
JAX package saves, loaded with the whole-row attention and fused GEGLU
routes on; 2 DDIM steps at 32x64), both ranks replaying the noise of the
JAX `D3RoMa`'s keys:

- its depth against the port's tp=1 depth at TP_ATOL (1e-4 m, the JAX
  package's own tensor-parallel test, tests/test_inference.py);
- its depth against the JAX `D3RoMa` at task.tensor_parallel=2 (its
  kernels in interpret mode, through their shard_map compositions), within
  DEPTH_RTOL, the inference parity test's tolerance;
- both ranks return the same depth; the 512-token attention sites ran
  `mha_attention_tp`, the 64-channel feed-forward `geglu_ff_tp` (the
  32-channel ones fail `tp_geglu_ok`, F/2 = 64, and run unfused, as in the
  JAX package); each rank holds less than the whole model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.inference import D3RoMa as JaxD3RoMa
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.utils.camera import Realsense as JaxRealsense
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
import torch_port_utils as U

H, W = 32, 64
STEPS = 2
TP_ATOL = 1e-4
DEPTH_RTOL = 1e-4


def _save_jax_pipe(path, seed):
    unet = U.randomize_(UNet2DCondition(**U.TINY_UNET, device="cpu"), seed)
    vae = U.randomize_(AutoencoderKL(**U.TINY_VAE, device="cpu"), seed + 1)
    JaxPipeline(
        unet=JaxUNet(**U.TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray,
                                           unet_torch_to_flax(U.state_dict_numpy(unet))),
        vae=JaxVAE(**U.TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray,
                                          vae_torch_to_flax(U.state_dict_numpy(vae))),
        text_embed=jnp.asarray(U.randn(seed + 2, 1, 2, U.TINY_UNET["cross_attention_dim"])),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                                 ch_gammas=(1.0,))).save_pretrained(str(path))


def test_tensor_parallel_d3roma_matches_tp1_and_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # D3RoMa makes _outputs.<variant>/ here
    _save_jax_pipe(tmp_path / "rgb_raw", 0)
    ov = ["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tmp_path / 'rgb_raw'}",
          f"task.image_size=[{H},{W}]", f"task.num_inference_timesteps={STEPS}",
          "task.num_intermediate_images=1"]
    rs = np.random.RandomState(0)
    frames = [(rs.randint(0, 256, (36, 64, 3)).astype(np.uint8),
               rs.uniform(0.3, 3.0, (36, 64)).astype(np.float32))]
    # the keys the JAX D3RoMa splits, one a call, and their noise
    key, keys = jax.random.PRNGKey(0), []
    for _ in frames:
        key, sub = jax.random.split(key)
        keys.append(sub)
    draws = [U.jax_noise_schedule(k, (1, H // 2, W // 2, 4), STEPS) for k in keys]

    outs = U.run_ranks(U.tp_d3roma_ranks, 2, ov, str(tmp_path / "rgb_raw"), draws, frames)
    (depths, launches, nbytes), other = outs[0], outs[1]
    for a, b in zip(depths[2], other[0][2]):
        np.testing.assert_array_equal(a, b)
    # a pass: the 3 self-attention sites of the 512-token level, the
    # mid block's feed-forward (C = 64); the 3 at C = 32 run unfused
    assert launches["mha_attention_tp"] == launches["mha_attention"] == 3 * STEPS
    assert launches["geglu_ff_tp"] == launches["geglu_ff"] == STEPS
    assert nbytes[2] < nbytes[1]

    monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
    pipe = JaxPipeline.from_pretrained(str(tmp_path / "rgb_raw"))
    pipe = dataclasses.replace(pipe, unet=dataclasses.replace(
        pipe.unet, use_flash_attention="pallas-self", fused_ff=True))
    ref = JaxD3RoMa(ov + ["task.tensor_parallel=2"], JaxRealsense.default_real("fxm"),
                    variant="rgb+raw", pipeline=pipe)
    for (rgb, raw), tp1, tp2 in zip(frames, depths[1], depths[2]):
        assert np.isfinite(tp2).all() and np.ptp(tp2) > 0
        np.testing.assert_allclose(tp2, tp1, rtol=0, atol=TP_ATOL)
        np.testing.assert_allclose(tp2, ref.infer_with_rgb_raw(rgb, raw), rtol=DEPTH_RTOL,
                                   atol=0)
