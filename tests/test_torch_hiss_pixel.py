"""The synthetic-data workflow on the CPU, at a tiny size: the port's
replicator launcher renders a HISS tree (64x36, one surface of 4 frames
for train and one of 2 for val, each into a scene directory under its
split: both packages' HISS loaders list `root/split/*/*_color.png`, one
directory level, so the launcher's default `datasets/HISS/train` would give
them no item), `python -m d3roma_tpu_torch.stereo_matching
--device cpu` writes every pair's `_simDepthImage.exr` (the render's focal
length, disparities 1..16, block 5), and one `train_hiss` step of the pixel
family at the preset's left+right+raw conditions, through each package's
`train()` on that tree, from the same pipeline directory (a tiny UNet2D,
8 input channels) with the port replaying the JAX step keys' draws. The
step's loss and grad_norm and the parameters after it are held to the
tolerances of tests/test_torch_train_loop.py (loss 1e-5, grad_norm 1e-4
relative; every parameter within 2 learning rates, 99.9% of them within
1e-3 of one, the key biases apart).

The loader's left+right+raw items are held to the JAX package's on the
same tree first, bit for bit (both read the same files with numpy).

The trainer builds the pixel UNet with `remat` (each resnet and attention
block recomputed in the backward pass): the preset's batch 32 at 256x320 in
fp32 needed more than the H100's 80 GB without it (eager PyTorch keeps
every activation; the JAX package's XLA schedules its own memory). On the
CPU: the remat model's output and gradients equal the plain model's bit for
bit, and autograd keeps under a third of the plain model's bytes for the
backward pass."""

import math
import os
import subprocess
import sys

import torch

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import d3roma_tpu.training.train_loop as jax_loop
import d3roma_tpu_torch.training.train_loop as port_loop
from d3roma_tpu.config import compose as jax_compose
from d3roma_tpu.data import fetch_dataloader as jax_fetch
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.pipelines import GuidedDiffusionPipeline as JaxPixelPipeline
from d3roma_tpu.pipelines import create_sampler_spec as jax_sampler_spec
from d3roma_tpu_torch import render_synthetic
from d3roma_tpu_torch.config import compose
from d3roma_tpu_torch.data import fetch_dataloader
from d3roma_tpu_torch.models import UNet2D, flax_unet2d_to_torch, init_random_
from d3roma_tpu_torch.utils.exr import read_exr
from torch_port_utils import TINY_UNET2D, JaxKeyDraws, random_flax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
W, H = 64, 36
FOCAL = W / (2 * math.tan(math.radians(71.28) / 2))  # the launcher's D435 field of view
PORT_DETECTOR = port_loop.AbnormalLossDetector
JAX_DETECTOR = jax_loop.AbnormalLossDetector
OVERRIDES = ["task=train_hiss", f"task.camera_resolution={W}x{H}", "task.image_size=[32,48]",
             "task.divis_by=16", "task.train_batch_size=2", "task.eval_batch_size=2",
             "task.num_epochs=1", "task.val_every_global_steps=1000",
             "task.save_model_epochs=1000", f"task.learning_rate={LR}",
             "task.lr_warmup_steps=0", "seed=3"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The rendered tree with its sim depth, and the JAX package's pipeline
    directory both runs start from."""
    root = tmp_path_factory.mktemp("hiss_pixel")
    for split, frames, seed in (("train", 4, 5), ("val", 2, 6)):
        assert render_synthetic.main([
            "--backend", "sim", f"depth_sensor.resolution=[{W}, {H}]",
            f"num_frames_per_surface={frames}", "max_surfaces=1", f"seed={seed}",
            f"writer_config.output_dir={root / 'datasets' / 'HISS' / split / 'hssd'}"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "d3roma_tpu_torch.stereo_matching", str(root / "datasets"),
         "--device", "cpu", "--fx", str(FOCAL), "--min-disp", "1", "--max-disp", "16",
         "--block", "5"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    base = jax_compose(OVERRIDES)
    unet = JaxUNet2D(**dict(TINY_UNET2D, in_channels=8))
    params = random_flax_tree(unet, 0, jnp.zeros((1, 32, 48, 8)), jnp.array([0]))
    JaxPixelPipeline(unet=unet, unet_params=jax.tree.map(jnp.asarray, params),
                     spec=jax_sampler_spec(base.task, train=False),
                     guidance=JaxGuidance(flow_guidance_weight=0.0),
                     normalizer=JaxNormalizer.from_config(base.task)).save_pretrained(
        str(root / "init"))
    return root


def test_sim_depth_written_for_every_pair(tree):
    for split, frames in (("train", 4), ("val", 2)):
        for i in range(frames):
            depth = read_exr(str(tree / "datasets" / "HISS" / split / "hssd"
                                  / f"{i:04d}_simDepthImage.exr"))
            assert depth.shape == (H, W) and np.isfinite(depth).all()
            assert (depth > 0).mean() > 0.3, (split, i)  # the matcher found most pixels


def test_loader_items_match_jax(tree, monkeypatch):
    monkeypatch.chdir(tree)
    jcfg, pcfg = jax_compose(OVERRIDES).task, compose(OVERRIDES).task
    jds, ods = jax_fetch(jcfg, seed=3)[0].dataset, fetch_dataloader(pcfg, seed=3)[0].dataset
    assert len(ods) == len(jds) == 4
    for i in range(len(jds)):
        ref, ours = jds[i], ods[i]
        for k in ("disp", "valid", "depth", "raw_depth", "left", "right", "rgb"):
            assert ours[k].shape == ref[k].shape[:2] + ours[k].shape[2:], k
            assert np.array_equal(ours[k], np.asarray(ref[k])), (i, k)
        assert ours["left"].shape[-1] == 3 and float(ours["raw_depth"].max()) > 0


def _recorder(cls, log):
    class Recording(cls):
        def check(self, loss, avg_loss, history_len, global_step, batch=None, metrics=None,
                  paths=None):
            log.append((global_step, float(loss), float(metrics["grad_norm"])))
            return super().check(loss, avg_loss, history_len, global_step, batch, metrics, paths)

    return Recording


def test_one_left_right_raw_step_matches_jax(tree, monkeypatch):
    monkeypatch.chdir(tree)
    overrides = OVERRIDES + [f"task.resume_pretrained={tree / 'init'}"]
    jbase = jax_compose(overrides)
    jbase.task.eval_dataset = []
    jlog = []
    monkeypatch.setattr(jax_loop, "AbnormalLossDetector", _recorder(JAX_DETECTOR, jlog))
    jstate, _, _ = jax_loop.train(jbase.task, jbase, str(tree / "jax_run"), 1)
    base = compose(overrides)
    base.task.eval_dataset = []
    log = []
    monkeypatch.setattr(port_loop, "AbnormalLossDetector", _recorder(PORT_DETECTOR, log))
    monkeypatch.setattr(port_loop, "step_draws", lambda seed, step, device: JaxKeyDraws(
        jax.random.fold_in(jax.random.PRNGKey(seed), step), base.task.noise_strategy))
    _, counter, models = port_loop.train(base.task, base, str(tree / "port_run"), 1,
                                         device="cpu")
    assert base.task.cond_channels == "left+right+raw" and base.task.prediction_type == "sample"
    assert [g for g, _, _ in log] == [g for g, _, _ in jlog] == [0]
    (_, loss, gn), (_, jl, jgn) = log[0], jlog[0]
    assert math.isfinite(loss)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    np.testing.assert_allclose(gn, jgn, rtol=1e-4)
    assert counter.global_step == 1
    ref = flax_unet2d_to_torch(jax.tree.map(np.asarray, jstate.params))
    ours = models["unet"].state_dict()
    assert ours["conv_in.weight"].shape[1] == 8
    diffs = {k: np.abs(ours[k].numpy() - ref[k].numpy()).ravel() for k in ref}
    assert np.concatenate(list(diffs.values())).max() <= 2 * LR
    rest = np.concatenate([d for k, d in diffs.items() if not k.endswith("to_k.bias")])
    assert np.quantile(rest, 0.999) <= 1e-3 * LR


def _saved_bytes_and_grads(unet, x, t):
    """The bytes autograd keeps for the backward pass of one forward, the
    output and the parameters' gradients."""
    saved = [0]

    def pack(tensor):
        saved[0] += tensor.numel() * tensor.element_size()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        out = unet(x, t)
    out.square().mean().backward()
    return saved[0], out.detach(), {k: p.grad.clone() for k, p in unet.named_parameters()}


def test_pixel_unet_remat_keeps_the_arithmetic_and_frees_activations(monkeypatch):
    kw = dict(TINY_UNET2D, in_channels=8, device="cpu")
    plain = init_random_(UNet2D(**kw), torch.Generator().manual_seed(0))
    remat = UNet2D(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 32, 48, 8, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 90])
    plain_bytes, plain_out, plain_grads = _saved_bytes_and_grads(plain, x, t)
    remat_bytes, remat_out, remat_grads = _saved_bytes_and_grads(remat, x, t)
    assert torch.equal(remat_out, plain_out)
    for k, g in plain_grads.items():
        assert torch.equal(remat_grads[k], g), k
    assert remat_bytes < plain_bytes / 3, (remat_bytes, plain_bytes)
    # the trainer builds it so, fresh or from a pipeline directory
    monkeypatch.chdir(REPO)
    cfg = compose(OVERRIDES + ["task.block_out_channels=[16,32]"]).task
    assert port_loop.build_models(cfg, 0, "cpu")["unet"].remat
