"""The evaluation loop under `guide_source="stereo-match"` against the JAX
package's, on a tiny left+right+raw latent model (torch_port_utils' tiny
widths, conv_in widened to 16 channels) saved by the JAX package and two
procedural HISS frames at 36x64 (padded 40x64), one batch, two DDIM steps,
gradient guidance at weight 1.0 under SSI least squares, the JAX key
schedule replayed as explicit noise (tests/test_torch_evaluate.py).

The block matcher on the padded IR pair (D 1..11 at this width) replaces
the raw disparity as the guidance and SSI target: the target each package
passes to its pipeline holds the same validity on VALID_AGREE of the
pixels and the same disparity within tests/test_torch_stereo.py's
DISP_ATOL where both are valid; the per-sample metrics meet
tests/test_torch_evaluate.py's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_evaluate as evaluate_tests
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.pipelines import create_sampler_spec as jax_sampler_spec
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from test_torch_stereo import DISP_ATOL
from torch_port_utils import TINY_UNET, TINY_VAE, jax_noise_schedule, randn, randomize_, \
    state_dict_numpy

VALID_AGREE = 0.995
GUIDE = dict(flow_guidance_weight=1.0, flow_guidance_mode="gradient", num_opt_steps=2,
             opt_lr=0.05)
UNET = dict(TINY_UNET, in_channels=16)
CONFIG = dict(cond_channels="left+right+raw", guide_source="stereo-match",
              flow_guidance_weights=[1.0], ssi=True, safe_ssi=False, eval_num_batch=1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_stereo")
    unet = randomize_(UNet2DCondition(**UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    JaxPipeline(
        unet=JaxUNet(**UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray, unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(randn(2, 1, 2, TINY_UNET["cross_attention_dim"])),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(**GUIDE),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(8.0,),
                                 ch_gammas=(1.0,))).save_pretrained(str(root / "pipe"))
    generate_dataset(str(root / "datasets" / "HISS"), evaluate_tests.BATCH, split="test",
                     config=SceneConfig(height=36, width=64), seed=11)
    return root


class _Spy:
    """Records the guidance target each pipeline call receives."""

    def __init__(self, pipe, seen):
        self.pipe, self.seen = pipe, seen

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, *args, **kw):
        self.seen.append(np.asarray(kw["raw_depth"], np.float32))
        return self.pipe(*args, **kw)


class _Replay:
    """The port's pipeline drawing the JAX package's noise, one key a call."""

    def __init__(self, pipe, keys):
        self.pipe, self.keys = pipe, list(keys)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        b, h, w, _ = kw["sim_disp"].shape
        x_init, noise = jax_noise_schedule(self.keys.pop(0), (b, h // 2, w // 2, 4),
                                           kw["num_inference_steps"])
        return self.pipe(latents=torch.from_numpy(x_init),
                         step_noise=[torch.from_numpy(n) for n in noise], **kw)


def test_eval_stereo_match_guidance_matches_jax(tree, monkeypatch):
    jcfg, pcfg = evaluate_tests._configs(**CONFIG)
    jax_pipe = JaxPipeline.from_pretrained(str(tree / "pipe")).replace_sampler(
        jax_sampler_spec(jcfg, train=False))
    port = GuidedLatentDiffusionPipeline.from_pretrained(str(tree / "pipe"), device="cpu")
    port = port.replace_sampler(create_sampler_spec(pcfg, train=False))
    assert port.guidance.enabled
    ref_seen, our_seen = [], []

    def replay(key, cfg):
        keys = evaluate_tests._jax_keys(key, 1, 1, cfg.num_inference_rounds)
        return _Spy(_Replay(port, keys), our_seen)

    (ref, ref_stat), (ours, stat) = evaluate_tests._run_both(
        tree, _Spy(jax_pipe, ref_seen), replay, monkeypatch, **CONFIG)

    assert len(ref_seen) == len(our_seen) == 1
    want, got = ref_seen[0], our_seen[0]
    assert got.shape == want.shape == (evaluate_tests.BATCH, 40, 64, 1)
    assert 0.2 < (want > 0).mean() < 1.0
    assert ((got > 0) == (want > 0)).mean() >= VALID_AGREE
    both = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=DISP_ATOL)

    assert ours.keys() == ref.keys() == {"disp", "depth"}
    assert len(ref_stat._recent["epe"]) == evaluate_tests.BATCH
    for k, vals in ref_stat._recent.items():
        if k in evaluate_tests.RATES:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=0, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=1e-4, atol=0, err_msg=k)
