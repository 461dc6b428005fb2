"""The port's offline entry points against the JAX package's scripts on the
CPU:

- `python -m d3roma_tpu_torch.stereo_matching` and `scripts/stereo_matching.py`
  on copies of one 2-frame 96x160 procedural HISS tree (D 4..40): the
  `*_simDepthImage.exr` files hold the same validity on VALID_AGREE of the
  pixels and the same depth within DEPTH_RTOL where both are valid (the
  matcher's disparities agree to tests/test_torch_stereo.py's DISP_ATOL
  px, and depth = fxb / disparity; measured: the same validity, depth
  within 1.04e-4); the `*_simDispImage.png` files (the disparity truncated
  to uint8) equal on DISP_PNG_AGREE of the pixels and one apart at most
  elsewhere (measured: equal);
- `check_stereo.check` on each package's HISS dataset of that tree: the
  same bad lists at two ratios and the printed photometric losses within
  LOSS_ATOL (4 printed decimals);
- `check_sceneflow` on a SceneFlow-layout tree of PFMs: the same
  `bad_his.txt`;
- `calibrate_pipeline` on one tiny saved pipeline (32x64, 1 frame, 2
  steps), the port's noise replayed from the JAX script's key. The port
  calibrates the serving configuration (`fast_inference("throughput")`),
  the JAX script the directory as loaded: against the JAX package's
  calibration of the serving configuration on the script's batch and key,
  the same tables and lengths, every scale within SCALE_RTOL and the
  median within SCALE_MEDIAN_RTOL (absmax taps of bf16 activations whose
  rounding differs between the packages, a bf16 ulp being 2^-8 relative;
  measured max 1.4e-2 to 1.8e-2 in the UNet and the encode, 4.6e-2 in the
  decode, which follows two bf16 UNet steps, median 1.3e-2 there); against the script's file,
  the same tables, the VAE's as long, the UNet's longer by one scale per
  fused GEGLU site; the file loaded by `from_pretrained`."""

import importlib
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu_torch import calibrate_pipeline, check_sceneflow, check_stereo, stereo_matching
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from d3roma_tpu_torch.utils import png
from d3roma_tpu_torch.utils.exr import read_exr
from d3roma_tpu_torch.utils.frame_utils import writePFM
from torch_port_utils import TINY_UNET, TINY_VAE, randn, randomize_, state_dict_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

VALID_AGREE = 0.995
DEPTH_RTOL = 1e-2
DISP_PNG_AGREE = 0.995
LOSS_ATOL = 1.5e-4
SCALE_RTOL = 1e-1
SCALE_MEDIAN_RTOL = 3e-2
STEREO_ARGS = ["--min-disp", "4", "--max-disp", "40", "--batch", "2", "--overwrite",
               "--fx", "223.2", "--baseline", "0.055"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One procedural HISS tree matched by the JAX script, a copy by the
    port's entry point."""
    root = tmp_path_factory.mktemp("offline")
    generate_dataset(str(root / "jax" / "HISS"), 2, split="train",
                     config=SceneConfig(height=96, width=160), seed=0)
    shutil.copytree(root / "jax", root / "port")
    importlib.import_module("stereo_matching").main([str(root / "jax" / "HISS")] + STEREO_ARGS)
    assert stereo_matching.main([str(root / "port" / "HISS"), "--device", "cpu"]
                                + STEREO_ARGS) == 0
    return root


def test_stereo_matching_cli_matches_jax(trees):
    scene = "HISS/train/scene_0000"
    names = sorted(os.listdir(trees / "jax" / scene))
    assert names == sorted(os.listdir(trees / "port" / scene))
    for i in range(2):
        ref = read_exr(str(trees / "jax" / scene / f"{i:04d}_simDepthImage.exr"))
        ours = read_exr(str(trees / "port" / scene / f"{i:04d}_simDepthImage.exr"))
        assert ours.shape == ref.shape == (96, 160) and np.isfinite(ours).all()
        assert (ours > 0).mean() > 0.2  # the matcher found a good fraction
        assert ((ours > 0) == (ref > 0)).mean() >= VALID_AGREE
        both = (ours > 0) & (ref > 0)
        np.testing.assert_allclose(ours[both], ref[both], rtol=DEPTH_RTOL)
        d_ref = png.read_png(str(trees / "jax" / scene / f"{i:04d}_simDispImage.png"))
        d_ours = png.read_png(str(trees / "port" / scene / f"{i:04d}_simDispImage.png"))
        assert d_ours.dtype == np.uint8 and d_ours.shape == (96, 160)
        assert (d_ours == d_ref).mean() >= DISP_PNG_AGREE
        assert np.abs(d_ours.astype(int) - d_ref.astype(int))[both].max() <= 1


def test_stereo_matching_refuses_colour_ir(tmp_path):
    png.write_png(str(tmp_path / "0000_ir_l.png"), np.zeros((8, 8, 3), np.uint8))
    png.write_png(str(tmp_path / "0000_ir_r.png"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="8-bit gray"):
        stereo_matching.main([str(tmp_path), "--device", "cpu"])


def _losses(text):
    return [(float(a), float(b)) for a, b in
            re.findall(r"photometric L1 gt=([0-9.]+) sim=([0-9.]+)", text)]


def test_check_stereo_matches_jax(trees, tmp_path, capsys):
    from functools import partial

    from d3roma_tpu.data.datasets import HISS as JaxHISS
    from d3roma_tpu.utils import frame_utils as jax_frame_utils
    from d3roma_tpu.utils.camera import Realsense as JaxRealsense
    from d3roma_tpu_torch.data.datasets import HISS
    from d3roma_tpu_torch.utils import frame_utils
    from d3roma_tpu_torch.utils.camera import Realsense

    jax_cs = importlib.import_module("check_stereo")
    datasets = []
    for cam_cls, ds_cls, fu in ((JaxRealsense, JaxHISS, jax_frame_utils),
                                (Realsense, HISS, frame_utils)):
        cam = cam_cls.default_sim(min_depth=0.2, max_depth=3.0)
        cam.change_resolution("160x96")
        datasets.append(ds_cls(cam, (96, 160), split="train", root=str(trees / "jax" / "HISS"),
                               reader=partial(fu.readDispReal, cam), seed=0))
    for ratio in (1e9, 0.5):
        capsys.readouterr()
        ref = jax_cs.check(datasets[0], str(tmp_path / "jax.txt"), ratio=ratio)
        ref_losses = _losses(capsys.readouterr().out)
        ours = check_stereo.check(datasets[1], str(tmp_path / "port.txt"), ratio=ratio,
                                  device="cpu")
        our_losses = _losses(capsys.readouterr().out)
        assert ours == ref and len(ref_losses) == len(our_losses) == 2
        np.testing.assert_allclose(our_losses, ref_losses, rtol=0, atol=LOSS_ATOL)
        assert open(tmp_path / "port.txt").read() == open(tmp_path / "jax.txt").read()
    assert ref  # ratio 0.5 flags a frame


def test_check_sceneflow_matches_jax(tmp_path):
    jax_csf = importlib.import_module("check_sceneflow")
    rng = np.random.default_rng(0)
    sub = tmp_path / "SceneFlow" / "FlyingThings3D" / "{}" / "TRAIN" / "A" / "0000" / "left"
    for kind in ("frames_cleanpass", "disparity", "raw_cleanpass"):
        os.makedirs(str(sub).format(kind))
    for i, noise in enumerate((0.2, 30.0, 0.5)):
        gt = rng.uniform(5, 50, (32, 48)).astype(np.float32)
        sim = (gt + rng.normal(0, noise, gt.shape)).astype(np.float32)
        png.write_png(str(sub).format("frames_cleanpass") + f"/{i:04d}.png",
                      np.zeros((32, 48, 3), np.uint8))
        writePFM(str(sub).format("disparity") + f"/{i:04d}.pfm", gt)
        writePFM(str(sub).format("raw_cleanpass") + f"/{i:04d}.pfm", sim)
    root = str(tmp_path / "SceneFlow")
    jax_csf.main(["--root", root, "--out", str(tmp_path / "jax.txt")])
    assert check_sceneflow.main(["--root", root, "--out", str(tmp_path / "port.txt")]) == 0
    ours = open(tmp_path / "port.txt").read()
    assert ours == open(tmp_path / "jax.txt").read()
    assert ours.endswith("0001.png") and "\n" not in ours


def _jax_batches(pipe, seed, h, w):
    """The JAX script's one calibration batch of one frame (its lines 55-71)."""
    from d3roma_tpu.synthetic.procedural import ProceduralSceneRenderer as JaxRenderer
    from d3roma_tpu.synthetic.procedural import SceneConfig as JaxSceneConfig

    f = JaxRenderer(JaxSceneConfig(height=h, width=w), seed=seed).render()
    rgb = (f["rgb"].astype(np.float32) / 255.0 - 0.5) * 2.0
    disp = np.where(f["sim_depth"] > 0, f["fxb"] / np.maximum(f["sim_depth"], 1e-6), 0.0)
    disp_b = jnp.asarray(disp[None, ..., None].astype(np.float32))
    return [dict(rgb_images=jnp.asarray(rgb[None]),
                 sim_disp=pipe.normalizer.normalize(disp_b, disp_b > 0)[0])]


def test_calibrate_pipeline_matches_jax(tmp_path, monkeypatch):
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
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(64.0,),
                                 ch_gammas=(1.0,))).save_pretrained(str(tmp_path / "pipe"))
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    args = [str(tmp_path / "pipe"), "--frames", "1", "--batches", "1", "--image-size", "32x64",
            "--steps", "2", "--seed", "3"]
    jax_main = importlib.import_module("calibrate_pipeline").main
    assert jax_main(args + ["--out", str(tmp_path / "jax")]) == 0
    with open(tmp_path / "jax" / "act_scales.json") as f:
        script = json.load(f)
    # the JAX package's calibration of the serving configuration, on the
    # script's batch and key
    jax_fast = JaxPipeline.from_pretrained(str(tmp_path / "pipe")).fast_inference("throughput")
    ref = jax_fast.calibrate(jax.random.PRNGKey(3), _jax_batches(jax_fast, 3, 32, 64),
                             cond_channels="rgb+raw", num_inference_steps=2,
                             margin=1.25).act_scales

    # the noise the JAX calibration drew for batch 0 (key PRNGKey(seed))
    noise = np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(3), 0),
                                       (1, 16, 32, 4)))
    batches = calibrate_pipeline.calibration_batches

    def replayed(*a, **kw):
        return [dict(b, latents=torch.from_numpy(noise)) for b in batches(*a, **kw)]

    monkeypatch.setattr(calibrate_pipeline, "calibration_batches", replayed)
    assert calibrate_pipeline.main(args + ["--out", str(tmp_path / "port"), "--device",
                                           "cpu"]) == 0
    with open(tmp_path / "port" / "act_scales.json") as f:
        ours = json.load(f)
    assert set(ours) == set(ref) == set(script) == {"unet", "unet_cached", "vae_encode",
                                                    "vae_decode"}
    for table in ref:
        assert len(ours[table]) == len(ref[table]) > 0, table
        rel = np.abs(np.array(ours[table]) - ref[table]) / np.abs(ref[table])
        assert rel.max() <= SCALE_RTOL and np.median(rel) <= SCALE_MEDIAN_RTOL, (table, rel)
    # against the script's file: the VAE's tables as long; the UNet's shorter
    # by one scale for each fused GEGLU site (the script captures the
    # directory as loaded, two dense sites a feed-forward)
    port = GuidedLatentDiffusionPipeline.from_pretrained(str(tmp_path / "pipe"), device="cpu")
    call_map = port.fast_inference("throughput").quant_call_map(1, 32, 64)
    for table in ("vae_encode", "vae_decode"):
        assert len(ours[table]) == len(script[table]), table
    for table in ("unet", "unet_cached"):
        geglu = sum(1 for kind, _ in call_map[table] if kind == "geglu")
        assert geglu > 0 and len(script[table]) - len(ours[table]) == geglu, table
    shutil.copy(tmp_path / "port" / "act_scales.json", tmp_path / "pipe" / "act_scales.json")
    assert GuidedLatentDiffusionPipeline.from_pretrained(str(tmp_path / "pipe"),
                                                         device="cpu").act_scales == ours
