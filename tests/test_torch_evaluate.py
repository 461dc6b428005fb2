"""The evaluation loop end to end against the JAX package's, on the same
pipeline directory (written by the JAX package's save_pretrained, loaded by
each package's from_pretrained) and the same procedural HISS frames (four
36x64 frames, two batches of two, two DDIM steps):

- `evaluate_dataset` with the tiny latent model (torch_port_utils' TINY_UNET
  and TINY_VAE), the JAX key schedule replayed as explicit noise through a
  wrapper around the port's pipeline (fold_in(fold_in(key, batch), round):
  split for the initial latents, split(k, 3) a step), plain, with
  coarse_to_fine, and with two rounds ensembled. Per-sample metrics within
  1e-4 relative for the continuous ones (epe, rmse, rel, mae: float32
  pipelines whose images agree to ~1e-6), 1e-3 where two rounds are
  ensembled (30 Adam steps on the rounds amplify those differences), and
  2e-3 absolute for the threshold rates (d1-d5, a1-a3: a last-place
  difference may move a pixel across a threshold, 1/2304 of a frame); the
  aggregate keys equal;
- the loop's bookkeeping with a deterministic stand-in pipeline in both
  packages (its output is its sim_disp input) and one metric function for
  both (the JAX compute_errors, whose float32 sums XLA orders otherwise
  than PyTorch): the same dicts bit for bit, over a guidance-weight sweep
  and two rounds, and the same artifacts;
- the golden stages: a JAX dump compared by the port, a port dump (on the
  JAX probe inputs) compared by the JAX package, every stage ok;
- `python -m d3roma_tpu_torch.evaluate --device cpu` in a subprocess: exit
  0, the artifacts written and readable by the port's own readers, and its
  metrics equal to the same run in process."""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.config import load_task_preset as jax_preset
from d3roma_tpu.data import fetch_dataloader as jax_fetch
from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
from d3roma_tpu.evaluation import golden as jax_golden
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
from d3roma_tpu_torch.data import preprocess_eval, val_loaders
from d3roma_tpu_torch.evaluation import evaluate_dataset, golden
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, PipelineOutput
from d3roma_tpu_torch.pipelines import create_sampler_spec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from d3roma_tpu_torch.utils import png
from d3roma_tpu_torch.utils.exr import read_exr
from torch_port_utils import TINY_UNET, TINY_VAE, jax_noise_schedule, randn, randomize_, \
    state_dict_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, BATCH = 4, 2
OVERRIDES = dict(eval_dataset=["HISS"], camera_resolution="64x36", eval_batch_size=BATCH,
                 num_inference_timesteps=2, num_intermediate_images=2, ch_bounds=[8.0])
CASES = {"plain": {}, "coarse_to_fine": dict(coarse_to_fine=True),
         "rounds2_ensemble": dict(num_inference_rounds=2, ensemble=True)}
RATES = ("d1", "d2", "d3", "d5", "a1", "a2", "a3")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A JAX pipeline directory and the procedural frames under one root."""
    root = tmp_path_factory.mktemp("evaluate")
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 0)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), 1)
    jax_pipe = JaxPipeline(
        unet=JaxUNet(**TINY_UNET),
        unet_params=jax.tree_util.tree_map(jnp.asarray, unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(randn(2, 1, 2, TINY_UNET["cross_attention_dim"])),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(8.0,),
                                 ch_gammas=(1.0,)))
    jax_pipe.save_pretrained(str(root / "pipe"))
    generate_dataset(str(root / "datasets" / "HISS"), FRAMES, split="test",
                     config=SceneConfig(height=36, width=64), seed=11)
    return root


def _configs(**kw):
    out = []
    for load in (jax_preset, load_task_preset):
        cfg = load("eval_ldm_mixed_rgb+raw")
        for k, v in dict(OVERRIDES, **kw).items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


class _Replay:
    """The port's pipeline drawing the JAX package's noise: each call takes
    the next JAX key and passes its initial latents and step noise."""

    def __init__(self, pipe, keys, factor):
        self.pipe, self.keys, self.factor = pipe, list(keys), factor

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        b, h, w, _ = kw["rgb_images"].shape
        x_init, noise = jax_noise_schedule(self.keys.pop(0), (b, h // self.factor,
                                                              w // self.factor, 4),
                                           kw["num_inference_steps"])
        return self.pipe(latents=torch.from_numpy(x_init),
                         step_noise=[torch.from_numpy(n) for n in noise], **kw)


def _jax_keys(root, batches, quadrants, rounds):
    return [jax.random.fold_in(jax.random.fold_in(root, i), r)
            for i in range(batches) for _ in range(quadrants) for r in range(rounds)]


def _run_both(tree, jax_pipe, port_pipe, monkeypatch, **kw):
    monkeypatch.chdir(tree)
    jcfg, pcfg = _configs(**kw)
    key = jax.random.PRNGKey(0)
    ref = jax_evaluate(jcfg, jax_pipe, jax_fetch(jcfg)[1][0], key,
                       preprocess=partial(_preprocess_eval, config=jcfg,
                                          normalizer=JaxNormalizer.from_config(jcfg)))
    ours = evaluate_dataset(pcfg, port_pipe(key, pcfg), val_loaders(pcfg)[0],
                            torch.Generator().manual_seed(0),
                            preprocess=partial(preprocess_eval, config=pcfg,
                                               normalizer=Normalizer.from_config(pcfg),
                                               device="cpu"))
    return ref, ours


@pytest.fixture(scope="module")
def pipelines(tree):
    """Both packages' pipelines with the preset's sampler (one JAX pipeline
    object, so that the cases of one worker share its compiled programs)."""
    jcfg, pcfg = _configs()
    jax_pipe = JaxPipeline.from_pretrained(str(tree / "pipe")).replace_sampler(
        jax_sampler_spec(jcfg, train=False))
    port = GuidedLatentDiffusionPipeline.from_pretrained(str(tree / "pipe"), device="cpu")
    return jax_pipe, port.replace_sampler(create_sampler_spec(pcfg, train=False))


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_dataset_matches_jax(tree, pipelines, monkeypatch, case):
    jax_pipe, port = pipelines
    jcfg, pcfg = _configs(**CASES[case])
    quadrants = 4 if pcfg.coarse_to_fine else 1

    def replay(key, cfg):
        return _Replay(port, _jax_keys(key, FRAMES // BATCH, quadrants,
                                       cfg.num_inference_rounds), factor=2)

    (ref, ref_stat), (ours, stat) = _run_both(tree, jax_pipe, replay, monkeypatch,
                                              **CASES[case])
    assert ours.keys() == ref.keys() == {"disp", "depth"}
    assert all(ours[g].keys() == ref[g].keys() for g in ref)
    assert stat.num_rejected == ref_stat.num_rejected
    assert set(stat._recent) == set(ref_stat._recent)
    for k, vals in ref_stat._recent.items():
        assert len(stat._recent[k]) == len(vals) == FRAMES
        if k in RATES:
            np.testing.assert_allclose(stat._recent[k], vals, rtol=0, atol=2e-3, err_msg=k)
        else:
            rtol = 1e-3 if pcfg.ensemble else 1e-4
            np.testing.assert_allclose(stat._recent[k], vals, rtol=rtol, atol=0, err_msg=k)
    # the random weights give a spread of disparities, not a constant image
    assert 0.0 < ref["disp"]["d1"] < 1.0


@dataclasses.dataclass
class _JaxStandIn:
    """Output = the sim_disp condition, in the JAX pipeline's call form."""

    guidance: JaxGuidance = JaxGuidance(flow_guidance_weight=0.0)
    vae: object = None

    class Out(NamedTuple):
        images: jnp.ndarray
        intermediates: jnp.ndarray

    def __call__(self, key, **kw):
        return self.Out(kw["sim_disp"], kw["sim_disp"][None])


@dataclasses.dataclass
class _PortStandIn:
    guidance: FlowGuidance = FlowGuidance(flow_guidance_weight=0.0)
    vae: object = None
    device: str = "cpu"

    def __call__(self, generator=None, **kw):
        return PipelineOutput(kw["sim_disp"], kw["sim_disp"][None])


def test_bookkeeping_is_exact(tree, monkeypatch):
    kw = dict(flow_guidance_weights=[0.0, 1.0], num_inference_rounds=2)
    monkeypatch.chdir(tree)
    # one metric function for both loops (XLA's and PyTorch's float32 sums
    # differ in their last bits), so that what is compared is the loop: the
    # preprocess, padding, rounds, denormalize, the sweep and the averages
    from d3roma_tpu.ops import compute_errors as jax_errors
    from d3roma_tpu_torch.evaluation import eval_loop

    def shared_errors(gt, pred, space, masks, fxb):
        out = jax_errors(jnp.asarray(gt.numpy()), jnp.asarray(pred.numpy()), space,
                         jnp.asarray(masks.numpy()),
                         None if fxb is None else jnp.asarray(fxb.numpy()))
        return tuple(torch.from_numpy(np.array(o)) for o in out)

    monkeypatch.setattr(eval_loop, "compute_errors", shared_errors)
    jcfg, pcfg = _configs(**kw)
    ref, ref_stat = jax_evaluate(
        jcfg, _JaxStandIn(), jax_fetch(jcfg)[1][0], jax.random.PRNGKey(0),
        eval_output_dir=str(tree / "jax_art"), write_artifacts=True, dataset_name="HISS",
        preprocess=partial(_preprocess_eval, config=jcfg,
                           normalizer=JaxNormalizer.from_config(jcfg)))
    ours, stat = evaluate_dataset(
        pcfg, _PortStandIn(), val_loaders(pcfg)[0], torch.Generator().manual_seed(0),
        eval_output_dir=str(tree / "port_art"), write_artifacts=True, dataset_name="HISS",
        preprocess=partial(preprocess_eval, config=pcfg, normalizer=Normalizer.from_config(pcfg),
                           device="cpu"))
    assert set(ref["per_weight"]) == {0.0, 1.0}
    assert ours == ref
    assert stat.average() == ref_stat.average() and stat._recent == ref_stat._recent
    for i in range(FRAMES // BATCH):
        for b in range(BATCH):
            name = f"idx{i}_{b}_pred_disp.png"
            assert np.array_equal(png.read_png(str(tree / "port_art" / name)),
                                  png.read_png(str(tree / "jax_art" / name)))
            name = f"idx{i}_{b}_simDepthImage.exr"
            assert np.array_equal(read_exr(str(tree / "port_art" / name)),
                                  read_exr(str(tree / "jax_art" / name)))
        for name in (f"idx{i}_error.png", f"idx{i}_uncertainty.png", f"idx{i}_denoised.png"):
            assert os.path.exists(tree / "port_art" / name) == os.path.exists(
                tree / "jax_art" / name), name


def test_golden_both_ways(pipelines, tmp_path):
    jax_pipe, port = pipelines
    jax_golden.dump(jax_pipe, str(tmp_path / "jax"), H=32, W=64, seed=3)
    report = golden.compare(port, str(tmp_path / "jax"))
    assert list(report) == list(golden.STAGES)
    assert all(r["ok"] for r in report.values()), report
    # the port's dump on the JAX probe inputs, which the JAX compare draws again
    ref = np.load(str(tmp_path / "jax" / "golden_stages.npz"))
    golden.dump(port, str(tmp_path / "port"), H=32, W=64, seed=3,
                inputs=(ref["rgb"], ref["raw"], ref["x_t"]))
    report = jax_golden.compare(jax_pipe, str(tmp_path / "port"))
    assert all(r["ok"] for r in report.values()), report
    # a dump on the port's own draw, compared by the port
    golden.dump(port, str(tmp_path / "own"), H=32, W=64, seed=5)
    assert all(r["ok"] and r["max_abs"] == 0.0
               for r in golden.compare(port, str(tmp_path / "own")).values())


def test_evaluate_cli_matches_in_process(tree, pipelines, monkeypatch):
    out = tree / "cli_out"
    argv = ["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tree / 'pipe'}",
            "task.eval_dataset=[HISS]", "task.camera_resolution=64x36",
            f"task.eval_batch_size={BATCH}", "task.num_inference_timesteps=2",
            "task.num_intermediate_images=2", "task.ch_bounds=[8.0]", "task.eval_num_batch=1",
            f"task.eval_output={out}"]
    proc = subprocess.run([sys.executable, "-m", "d3roma_tpu_torch.evaluate", "--device", "cpu",
                           "--seed", "4"] + argv, cwd=tree, capture_output=True, text=True,
                          timeout=300,
                          # one thread, as this process: the same float sums
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["dataset"] == "HISS"
    art = out / "HISS"
    for b in range(BATCH):
        assert png.read_png(str(art / f"idx0_{b}_pred_disp.png")).shape == (36, 64, 3)
        depth = read_exr(str(art / f"idx0_{b}_simDepthImage.exr"))
        assert depth.shape == (36, 64) and np.isfinite(depth).all()
    assert png.read_png(str(art / "idx0_error.png")).shape == (36, 64, 3)
    assert png.read_png(str(art / "idx0_denoised.png")).shape == (36, 128, 3)  # two steps

    monkeypatch.chdir(tree)
    _, pcfg = _configs(eval_num_batch=1)
    port = pipelines[1]
    metrics, _ = evaluate_dataset(
        pcfg, port, val_loaders(pcfg)[0], torch.Generator().manual_seed(4),
        preprocess=partial(preprocess_eval, config=pcfg, normalizer=Normalizer.from_config(pcfg),
                           device="cpu"))
    assert line["metrics"] == json.loads(json.dumps(metrics))
