#!/usr/bin/env python
"""What gradient guidance does under each int8 mode, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python scripts/probe_guidance_quant.py

The tiny latent pipeline of tests/test_calibration.py (`_tiny_latent_pipe`:
UNet blocks 16/32, a 4-level VAE of 4-8 channels, 32x32 frames) with
gradient guidance on (2 Adam steps at lr 0.05, SSI least squares as the
denormalizer), 3 DDIM steps, the JAX
Pallas kernels in interpret mode: for fp32, `quantize_int8()` (dynamic int8)
and `fast_inference("throughput")` (static int8), max |guided - unguided|
of the images, in the JAX package (one key) and in the port (the same
weights, the JAX initial noise). Under static int8 every path from the
latent to the decode crosses a fixed-scale rounding, so the gradient is
zero and both print 0.0.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))
os.environ["D3ROMA_PALLAS_INTERPRET"] = "1"


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from d3roma_tpu_torch.guidance import FlowGuidance
    from d3roma_tpu_torch.models import (
        AutoencoderKL,
        UNet2DCondition,
        flax_unet_to_torch,
        flax_vae_to_torch,
    )
    from d3roma_tpu_torch.ops.normalizer import Normalizer
    from d3roma_tpu_torch.ops.schedules import ScheduleConfig
    from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
    from test_calibration import _tiny_latent_pipe

    base = _tiny_latent_pipe()
    gkw = dict(flow_guidance_weight=1.0, flow_guidance_mode="gradient", num_opt_steps=2,
               opt_lr=0.05)
    # SSI least squares in the guidance's denormalizer (no RANSAC draws)
    base = dataclasses.replace(base, guidance=dataclasses.replace(base.guidance, **gkw),
                               normalizer=dataclasses.replace(base.normalizer, safe_ssi=False))
    rs = np.random.RandomState(0)
    rgb = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    sim = rs.uniform(-1, 1, (1, 32, 32, 1)).astype(np.float32)
    raw = rs.uniform(5, 60, (1, 32, 32, 1)).astype(np.float32)
    raw[rs.rand(*raw.shape) < 0.1] = 0.0
    key = jax.random.PRNGKey(0)
    x_init = np.array(jax.random.normal(jax.random.split(key)[1], (1, 4, 4, 4), jnp.float32))
    kw = dict(num_inference_steps=3, num_intermediate_images=1, cond_channels="rgb+raw")

    def port_pipe():
        u, v = base.unet, base.vae
        unet = UNet2DCondition(in_channels=u.in_channels, out_channels=u.out_channels,
                               block_out_channels=u.block_out_channels,
                               down_block_types=u.down_block_types,
                               up_block_types=u.up_block_types,
                               layers_per_block=u.layers_per_block,
                               attention_head_dim=u.attention_head_dim,
                               cross_attention_dim=u.cross_attention_dim,
                               norm_groups=u.norm_groups, device="cpu")
        unet.load_state_dict(flax_unet_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                       base.unet_params)))
        vae = AutoencoderKL(block_out_channels=v.block_out_channels,
                            latent_channels=v.latent_channels, norm_groups=v.norm_groups,
                            device="cpu")
        vae.load_state_dict(flax_vae_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                     base.vae_params)))
        n = base.normalizer
        return GuidedLatentDiffusionPipeline(
            unet=unet, vae=vae, text_embed=torch.from_numpy(np.array(base.text_embed)),
            spec=SamplerSpec(base.spec.kind, ScheduleConfig(**dataclasses.asdict(
                base.spec.schedule))),
            normalizer=Normalizer(**dict(dataclasses.asdict(n), ch_bounds=tuple(n.ch_bounds),
                                         ch_gammas=tuple(n.ch_gammas))),
            guidance=FlowGuidance(**gkw), device="cpu")

    for mode in ("fp32", "quantize_int8", "throughput"):
        jp, pp = base, port_pipe()
        if mode == "quantize_int8":
            jp, pp = jp.quantize_int8(), pp.quantize_int8()
        elif mode == "throughput":
            jp, pp = jp.fast_inference("throughput"), pp.fast_inference("throughput")
        jn, pn = jp.normalizer, pp.normalizer
        out = {}
        for guided in (False, True):
            jg = dict(raw_depth=jnp.asarray(raw), denormer=lambda x: jn.denormalize(
                x, jnp.asarray(raw), jnp.asarray(raw > 0))) if guided else {}
            out[("jax", guided)] = np.asarray(jp(key, rgb_images=jnp.asarray(rgb),
                                                 sim_disp=jnp.asarray(sim), **kw, **jg).images,
                                              np.float32)
            pg = dict(raw_depth=torch.from_numpy(raw), denormer=lambda x: pn.denormalize(
                x, torch.from_numpy(raw), torch.from_numpy(raw > 0))) if guided else {}
            with torch.no_grad():
                out[("port", guided)] = pp(rgb_images=torch.from_numpy(rgb),
                                           sim_disp=torch.from_numpy(sim),
                                           latents=torch.from_numpy(x_init), **kw,
                                           **pg).images.float().numpy()
        print(f"{mode}: max |guided - unguided| JAX "
              f"{np.abs(out[('jax', True)] - out[('jax', False)]).max():.4g}, port "
              f"{np.abs(out[('port', True)] - out[('port', False)]).max():.4g}", flush=True)


if __name__ == "__main__":
    main()
