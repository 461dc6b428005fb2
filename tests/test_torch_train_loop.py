"""The port's training loop (`training/train_loop.py::train`) against the
JAX package's `train()`, on procedural HISS frames at a tiny size: the
pixel family (the `train_hiss` preset with RGB + raw conditions), both
packages starting from the same pipeline directory
(`task.resume_pretrained`), the port replaying the JAX step keys' draws
(`fold_in(PRNGKey(seed), step)`) through its `step_draws` seam. Two steps:
each step's loss and grad_norm (read where both loops hand them to the
abnormal-loss detector) and the parameters after them, with the train
step's tolerances (tests/test_torch_train_step.py).

Then the port alone: a run stopped at step 2 and resumed to the end of the
epoch equals an uninterrupted run bit for bit (the counter continues, the
data order and every draw replay, the optimizer and sampler state come
back), `best_epe` survives the resume, and the epoch export loads in the
JAX package's `from_pretrained` and computes the port's output within the
pipeline tolerance (1e-3 of max |ref|, as tests/test_torch_pretrained.py,
with the JAX key schedule replayed as explicit noise).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3roma_tpu.training.train_loop as jax_loop
import d3roma_tpu_torch.training.train_loop as port_loop
from d3roma_tpu.config import compose as jax_compose
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import UNet2D as JaxUNet2D
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.pipelines import GuidedDiffusionPipeline as JaxPixelPipeline
from d3roma_tpu.pipelines import create_sampler_spec as jax_sampler_spec
from d3roma_tpu_torch.config import compose
from d3roma_tpu_torch.models import flax_unet2d_to_torch
from d3roma_tpu_torch.pipelines import GuidedDiffusionPipeline
from d3roma_tpu_torch.synthetic.procedural import SceneConfig, generate_dataset
from torch_port_utils import TINY_UNET2D, JaxKeyDraws, jax_noise_schedule, random_flax_tree

LR = 1e-3
PORT_DETECTOR = port_loop.AbnormalLossDetector
JAX_DETECTOR = jax_loop.AbnormalLossDetector
OVERRIDES = ["task=train_hiss", "task.cond_channels=rgb+raw", "task.camera_resolution=64x36",
             "task.image_size=[32,48]", "task.divis_by=16", "task.train_batch_size=2",
             "task.eval_batch_size=2", "task.eval_num_batch=1", "task.num_epochs=1",
             "task.val_every_global_steps=2", "task.save_model_epochs=1",
             "task.num_inference_timesteps=2", "task.num_intermediate_images=1",
             f"task.learning_rate={LR}", "task.lr_warmup_steps=0", "seed=3"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 train and 2 val frames at 64x36, and the JAX package's pipeline
    directory of a tiny UNet2D (random weights) both runs start from."""
    root = tmp_path_factory.mktemp("train_loop")
    cfg = SceneConfig(height=36, width=64)
    generate_dataset(str(root / "datasets" / "HISS"), 8, split="train", config=cfg)
    generate_dataset(str(root / "datasets" / "HISS"), 2, split="val", config=cfg, seed=1)
    base = jax_compose(OVERRIDES)
    unet = JaxUNet2D(**TINY_UNET2D)
    params = random_flax_tree(unet, 0, jnp.zeros((1, 32, 48, 5)), jnp.array([0]))
    JaxPixelPipeline(unet=unet, unet_params=jax.tree.map(jnp.asarray, params),
                     spec=jax_sampler_spec(base.task, train=False),
                     guidance=JaxGuidance(flow_guidance_weight=0.0),
                     normalizer=JaxNormalizer.from_config(base.task)).save_pretrained(
        str(root / "init"))
    return root


def _recorder(cls, log):
    class Recording(cls):
        def check(self, loss, avg_loss, history_len, global_step, batch=None, metrics=None,
                  paths=None):
            log.append((global_step, float(loss), float(metrics["grad_norm"])))
            return super().check(loss, avg_loss, history_len, global_step, batch, metrics, paths)

    return Recording


def _port_run(tree, out, monkeypatch, max_steps=None, replay=True, extra=()):
    monkeypatch.chdir(tree)
    base = compose(OVERRIDES + [f"task.resume_pretrained={tree / 'init'}"] + list(extra))
    log = []
    monkeypatch.setattr(port_loop, "AbnormalLossDetector", _recorder(PORT_DETECTOR, log))
    if replay:
        monkeypatch.setattr(port_loop, "step_draws", lambda seed, step, device: JaxKeyDraws(
            jax.random.fold_in(jax.random.PRNGKey(seed), step), base.task.noise_strategy))
    state, counter, models = port_loop.train(base.task, base, str(tree / out), max_steps,
                                             device="cpu")
    return state, counter, models, log


@pytest.fixture(scope="module")
def jax_two_steps(tree):
    mp = pytest.MonkeyPatch()
    mp.chdir(tree)
    base = jax_compose(OVERRIDES + [f"task.resume_pretrained={tree / 'init'}"])
    base.task.eval_dataset = []  # the JAX run is held to for its steps only
    log = []
    mp.setattr(jax_loop, "AbnormalLossDetector", _recorder(JAX_DETECTOR, log))
    try:
        state, counter, models = jax_loop.train(base.task, base, str(tree / "jax_run"), 2)
    finally:
        mp.undo()
    return jax.tree.map(np.asarray, state.params), log, counter


def test_two_steps_match_jax(tree, jax_two_steps, monkeypatch):
    jparams, jlog, jcounter = jax_two_steps
    state, counter, models, log = _port_run(tree, "port_run", monkeypatch, max_steps=2)
    assert [g for g, _, _ in log] == [g for g, _, _ in jlog] == [0, 1]
    for (_, loss, gn), (_, jl, jgn) in zip(log, jlog):
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        np.testing.assert_allclose(gn, jgn, rtol=1e-4)
    assert counter.global_step == jcounter.global_step == 2
    assert counter.local_step == jcounter.local_step == 2 and counter.epoch == 0
    ref = flax_unet2d_to_torch(jparams)
    ours = models["unet"].state_dict()
    diffs = {k: np.abs(ours[k].numpy() - ref[k].numpy()).ravel() for k in ref}
    every = np.concatenate(list(diffs.values()))
    assert every.max() <= 2 * LR * 2
    rest = np.concatenate([d for k, d in diffs.items() if not k.endswith("to_k.bias")])
    assert np.quantile(rest, 0.999) <= 1e-3 * LR * 2
    # the port evaluated at step 2 and exported best/
    assert np.isfinite(counter.best_epe)
    assert os.path.exists(tree / "port_run" / "best" / "model_index.json")


def test_resume_replays_an_uninterrupted_run(tree, monkeypatch):
    _, first, _, log_a = _port_run(tree, "resumed", monkeypatch, max_steps=2, replay=False)
    with open(tree / "resumed" / "checkpoints" / "last" / "counter.json") as f:
        saved = json.load(f)
    assert saved["global_step"] == 2 and saved["local_step"] == 2 and saved["epoch"] == 0
    assert saved["best_epe"] == first.best_epe < float("inf")
    best_a = first.best_epe
    state_b, second, models_b, log_b = _port_run(tree, "resumed", monkeypatch, replay=False)
    assert [g for g, _, _ in log_b] == [2, 3]  # the counter continues
    assert second.global_step == 4 and second.epoch == 1 and second.local_step == 0
    assert second.best_epe <= best_a
    state_c, whole, models_c, log_c = _port_run(tree, "whole", monkeypatch, replay=False)
    assert [g for g, _, _ in log_c] == [0, 1, 2, 3]
    assert [x[1:] for x in log_a + log_b] == [x[1:] for x in log_c]
    assert whole.best_epe == second.best_epe
    for k, v in models_c["unet"].state_dict().items():
        assert torch.equal(models_b["unet"].state_dict()[k], v), k
    for k in ("mu", "nu"):
        for a, b in zip(state_b.optimizer.state[k], state_c.optimizer.state[k]):
            assert torch.equal(a, b)
    assert torch.equal(state_b.sampler_state.loss_history, state_c.sampler_state.loss_history)
    assert int(state_b.step) == int(state_c.step) == 4


def test_epoch_export_loads_in_jax(tree, monkeypatch):
    export = tree / "whole" / "epoch_0000"
    if not export.exists():
        _port_run(tree, "whole", monkeypatch, replay=False)
    jax_pipe = JaxPixelPipeline.from_pretrained(str(export))
    port = GuidedDiffusionPipeline.from_pretrained(str(export), device="cpu")
    rs = np.random.RandomState(0)
    rgb = rs.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    raw = np.clip(rs.standard_normal((2, 32, 48, 1)) * 0.5, -1, 1).astype(np.float32)
    kw = dict(num_inference_steps=2, num_intermediate_images=1, depth_channels=1,
              cond_channels="rgb+raw")
    ref = np.asarray(jax_pipe(jax.random.PRNGKey(5), rgb_images=jnp.asarray(rgb),
                              sim_disp=jnp.asarray(raw), **kw).images)
    x_init, noises = jax_noise_schedule(jax.random.PRNGKey(5), (2, 32, 48, 1), 2)
    got = port(rgb_images=torch.from_numpy(rgb), sim_disp=torch.from_numpy(raw),
               x_init=torch.from_numpy(x_init), step_noise=[torch.from_numpy(n) for n in noises],
               **kw).images.float().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max(), rtol=0)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
