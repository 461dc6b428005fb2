"""The mono slice as a whole against the JAX package, on the CPU.

- The loader of `train_ldm_mono` (NYUv2 + HyperSim, weights 1 and 1): the
  port's `fetch_dataloader` batches equal the JAX package's over two
  epochs, key for key and bit for bit (tolerance 0), on trees the test
  writes with h5py and PIL (NYUv2 official-split files at 480x640,
  HyperSim frames as JPEG + float16 HDF5).
- `eval_ldm_mono` end to end: a tiny latent pipeline (torch_port_utils'
  TINY_UNET and TINY_VAE, saved by the JAX package) evaluated over 2 NYUv2
  test items with the preset's `my_ddim` sampler, SSI alignment and its
  normalizer; the JAX key schedule replayed as explicit noise
  (`test_torch_evaluate._Replay`). Per-sample metrics within 2^-8: relative
  for the continuous ones (epe, rmse, rel, mae), absolute for the threshold
  rates (d1-d5, a1-a3); the aggregate keys equal.
"""

import os
from functools import partial

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from d3roma_tpu.config import load_task_preset as jax_preset
from d3roma_tpu.data import fetch_dataloader as jax_fetch
from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.pipelines import create_sampler_spec as jax_sampler_spec
from d3roma_tpu.training.train_loop import _preprocess_eval
from d3roma_tpu_torch.config import load_task_preset
from d3roma_tpu_torch.data import fetch_dataloader, preprocess_eval, val_loaders
from d3roma_tpu_torch.evaluation import evaluate_dataset
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
from test_torch_evaluate import _jax_keys, _Replay
from torch_port_utils import TINY_UNET, TINY_VAE, randn, randomize_, state_dict_numpy

TRAIN_FRAMES, EVAL_FRAMES = 4, 2
LOADER = dict(image_size=[32, 48], train_batch_size=4)
EVAL = dict(image_size=[32, 48], eval_batch_size=2, num_inference_timesteps=2,
            num_intermediate_images=2)
METRIC_TOL = 2.0 ** -8
RATES = ("d1", "d2", "d3", "d5", "a1", "a2", "a3")


def _scene(rng, h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([128 + 90 * np.sin(x / 37 + k) * np.cos(y / 29 - k) for k in range(3)], -1)
    rgb = np.clip(rgb + rng.normal(0, 6, rgb.shape), 0, 255).astype(np.uint8)
    depth = (0.6 + 6.0 * (x / w) * (0.5 + 0.5 * y / h)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.03] = 0
    return rgb, depth


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """NYUv2 (train and test) and HyperSim (train) trees at their default roots."""
    top = tmp_path_factory.mktemp("mono_slice")
    rng = np.random.default_rng(7)
    for split, n in (("train", TRAIN_FRAMES), ("test", EVAL_FRAMES)):
        for i in range(n):
            path = top / f"datasets/nyu_depth_v2/official_splits/{split}/room_{i}/{i:05d}.h5"
            os.makedirs(path.parent)
            rgb, depth = _scene(rng, 480, 640)
            with h5py.File(path, "w") as f:
                f.create_dataset("rgb", data=rgb.transpose(2, 0, 1), chunks=(3, 120, 160),
                                 compression="gzip")
                f.create_dataset("depth", data=depth, chunks=(120, 160), compression="gzip")
    for i in range(TRAIN_FRAMES):
        stem = top / f"datasets/hypersim/train/ai_00{i}/images/frame.{i:04d}"
        os.makedirs(stem.parent)
        rgb, depth = _scene(rng, 48, 64)
        Image.fromarray(rgb).save(f"{stem}.tonemap.jpg", quality=90)
        with h5py.File(f"{stem}.depth_meters.hdf5", "w") as f:
            f.create_dataset("dataset", data=depth.astype(np.float16), compression="gzip")
    return top


def _configs(preset, overrides):
    out = []
    for load in (jax_preset, load_task_preset):
        cfg = load(preset)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def test_train_loader_batches_equal_jax(root, monkeypatch):
    monkeypatch.chdir(root)
    jcfg, cfg = _configs("train_ldm_mono", LOADER)
    assert list(cfg.train_dataset) == ["NYUv2", "HyperSim"]
    ref, ours = jax_fetch(jcfg, seed=0)[0], fetch_dataloader(cfg, seed=0)[0]
    assert len(ours) == len(ref) == 2 * TRAIN_FRAMES // LOADER["train_batch_size"]
    for epoch in range(2):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        batches = 0
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys()
            for k in b:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)
            batches += 1
        assert batches == len(ref)


@pytest.fixture(scope="module")
def pipelines(root):
    """One random tiny latent pipeline, saved by the JAX package and loaded
    by each package, with the preset's sampler and normalizer."""
    jcfg, cfg = _configs("eval_ldm_mono", EVAL)
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    JaxPipeline(
        unet=JaxUNet(**TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray, unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(randn(2, 1, 2, TINY_UNET["cross_attention_dim"])),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer.from_config(jcfg)).save_pretrained(str(root / "pipe"))
    jax_pipe = JaxPipeline.from_pretrained(str(root / "pipe")).replace_sampler(
        jax_sampler_spec(jcfg, train=False))
    port = GuidedLatentDiffusionPipeline.from_pretrained(str(root / "pipe"), device="cpu")
    return jax_pipe, port.replace_sampler(create_sampler_spec(cfg, train=False))


def test_eval_ldm_mono_matches_jax(root, pipelines, monkeypatch):
    monkeypatch.chdir(root)
    jax_pipe, port = pipelines
    jcfg, cfg = _configs("eval_ldm_mono", EVAL)
    assert list(cfg.eval_dataset) == ["NYUv2"] and cfg.ssi and cfg.sampler == "my_ddim"
    key = jax.random.PRNGKey(0)
    ref, ref_stat = jax_evaluate(
        jcfg, jax_pipe, jax_fetch(jcfg)[1][0], key,
        preprocess=partial(_preprocess_eval, config=jcfg,
                           normalizer=JaxNormalizer.from_config(jcfg)))
    replay = _Replay(port, _jax_keys(key, EVAL_FRAMES // EVAL["eval_batch_size"], 1, 1),
                     factor=2)
    ours, stat = evaluate_dataset(
        cfg, replay, val_loaders(cfg)[0], torch.Generator().manual_seed(0),
        preprocess=partial(preprocess_eval, config=cfg, normalizer=Normalizer.from_config(cfg),
                           device="cpu"))
    assert ours.keys() == ref.keys() == {"disp", "depth"}
    assert all(ours[g].keys() == ref[g].keys() for g in ref)
    assert stat.num_rejected == ref_stat.num_rejected
    assert set(stat._recent) == set(ref_stat._recent)
    for k, vals in ref_stat._recent.items():
        assert len(stat._recent[k]) == len(vals) == EVAL_FRAMES
        if k in RATES:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=0, atol=METRIC_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=METRIC_TOL, atol=0, err_msg=k)
    assert all(np.isfinite(v).all() for v in stat._recent.values())
    # the random weights give a spread of depths, not a constant image
    assert 0.0 < ref["depth"]["a3"] < 1.0
