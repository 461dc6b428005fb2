"""Multi-rank training of the port (data parallel, tensor parallel and
both) on the CPU: ranks are spawned processes of a gloo group over a
file:// store (`torch_port_utils.run_ranks`; their bodies are in
`torch_parallel_ranks.py`), the models tiny.

- Each tensor-parallel layer kind (column dense, row dense, conv, the GEGLU
  projection gathered in its halves' order and the feed-forward on paired
  chunks) under one loss: each rank's weight gradient equals its slice of
  the unsharded layer's, its output, input gradient and bias gradients the
  unsharded layer's (to fp32 rounding: 1e-5 of the largest element).
- The latent train step (SD-style UNet and VAE, v-prediction, noisy RGB)
  on DP2 and TP2 (two ranks) and on DP2 x TP2 (four ranks), and the pixel
  one (UNet2D) on DP2, against one process, two steps of AdamW (and of
  Adafactor for the latent one), the clip on: loss and
  per-sample loss within 1e-5 relative, grad_norm within 1e-4, timesteps
  and the sampler's counts equal, its history within 1e-5; the parameters
  by tests/test_torch_train_step.py's rule (every element within two
  learning rates a step, 99.9% outside the key biases within 1e-3 of the
  learning rate times the steps); the moments within 1e-3 of their
  tensor's largest element (outside the key biases, whose gradient is at
  the rounding level).
- Adafactor over whole parameters on a (1, 2) mesh: the cut dim at each
  place the factoring cares about, the parameters after each step within
  1e-6 of the one-process run's, the factored moments within 1e-5 of their
  largest element; a NaN in one rank's shard rejects the step on both.
- One data rank's non-finite rows reject the update on every rank: the
  parameters stay as they were, bit for bit, as in one process.
- The port's DP2 and TP2 steps of the latent family against the JAX
  `make_train_step` jitted once on `make_mesh_dp_tp(2, 2)` of the 8
  virtual CPU devices (the batch on its 2-device data axis, the state and
  the VAE sharded on its model axis), the JAX keys' draws replayed and the
  weights the JAX init's: the train step file's tolerances. The other
  cases draw their weights in the port (`randomize_`) and need no JAX.
- Checkpoints: a TP2 step-1 checkpoint resumed in one process, and a
  one-process step-1 checkpoint resumed on TP2, give the one-process
  step-2 state.
- The entry point on two ranks (torchrun's environment, `--device cpu`):
  one epoch whose losses are the one-process run's (within 1e-5), the
  files rank 0's only (rank 1 opened nothing for writing); a world of
  three ranks at batch 2 trains on DP2 and its third rank exits 0 having
  written nothing.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_utils import (
    jax_step_draws,
    random_flax_tree,
    randomize_,
    run_ranks,
    state_dict_numpy,
)

REPO = Path(__file__).resolve().parents[1]
B, HW, T, LR = 4, (16, 16), 20, 1e-3
UNET = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
            attention_head_dim=8, cross_attention_dim=16, norm_groups=4)
UNET2D = dict(in_channels=5, out_channels=1, block_out_channels=(8, 16),
              down_block_types=("DownBlock2D", "AttnDownBlock2D"),
              up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
              attention_head_dim=8, norm_groups=4)
VAE = dict(block_out_channels=(4, 8), latent_channels=4, norm_groups=2)
# the port's meshes held to the one JAX mesh step (the latent family,
# predicting epsilon: no decode in the JAX program, a shorter compile)
JAX_MESHES = {"dp2": (2, 1), "tp2": (1, 2)}
JAX_PREDICTION = "epsilon"


def _config(family="ldm", optimizer="adamw", prediction="v_prediction"):
    return dict(ldm=family == "ldm", depth_channels=4 if family == "ldm" else 1,
                cond_channels="rgb+raw", image_size=HW, divis_by=8, num_train_timesteps=T,
                beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012,
                prediction_type=prediction, noise_strategy="randn", loss_type="mse",
                train_batch_size=B, gradient_accumulation_steps=1, clip_grad_norm=1.0,
                learning_rate=LR, lr_warmup_steps=0, lr_scheduler="constant", clip_sample=False,
                timestep_sampler="uniform", noise_rgb=True, optimizer=optimizer)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    h, w = HW
    disp = rs.uniform(-1.1, 1.1, (B, h, w, 1)).astype(np.float32)
    return {"normalized_disp": disp,
            "sim_disp": (disp + 0.05 * rs.standard_normal(disp.shape)).astype(np.float32),
            "normalized_rgb": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            "left_image": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            "right_image": rs.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            "mask": (rs.rand(B, h, w, 1) > 0.2).astype(np.float32)}


class _Beside:
    """`run_ranks(fn, world, *args)` in a thread, beside the test's own
    work (the one-process reference, the JAX compile); `result()` joins."""

    def __init__(self, fn, world, *args):
        self.out = {}
        self.thread = threading.Thread(target=self._run, args=(fn, world) + args)
        self.thread.start()

    def _run(self, fn, world, *args):
        try:
            self.out["value"] = run_ranks(fn, world, *args)
        except BaseException as e:  # raised in result()
            self.out["error"] = e

    def result(self):
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"]


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The latent family's JAX modules and their numpy-seeded params."""
    from d3roma_tpu.models import AutoencoderKL as JaxVAE
    from d3roma_tpu.models import UNet2DCondition as JaxUNet

    unet = JaxUNet(**UNET)
    params = random_flax_tree(unet, 1, jnp.zeros((1, 8, 8, 12)), jnp.array([0]),
                              jnp.zeros((1, 2, 16)))
    vae = JaxVAE(**VAE)
    return unet, params, vae, random_flax_tree(vae, 2, jnp.zeros((1, 16, 16, 3)))


def _jax_states():
    """The port's state dicts (numpy) of the JAX models' params."""
    from d3roma_tpu_torch.models import flax_unet_to_torch, flax_vae_to_torch

    _, params, _, vae_params = _jax_models()
    return _np(flax_unet_to_torch(params)), _np(flax_vae_to_torch(vae_params))


@functools.lru_cache(maxsize=None)
def _states(family):
    """The port's models' state dicts (numpy), every parameter drawn from a
    numpy seed (`randomize_`)."""
    from d3roma_tpu_torch.models import AutoencoderKL, UNet2D, UNet2DCondition

    if family == "ldm":
        return (state_dict_numpy(randomize_(UNet2DCondition(**UNET, device="cpu"), 1)),
                state_dict_numpy(randomize_(AutoencoderKL(**VAE, device="cpu"), 2)))
    return state_dict_numpy(randomize_(UNet2D(**UNET2D, device="cpu"), 1)), None


def _spec(mesh, family="ldm", optimizer="adamw", steps=2, prediction="v_prediction",
          states=None, **extra):
    unet_state, vae_state = states or _states(family)
    spec = dict(config=_config(family, optimizer, prediction), mesh=mesh, steps=steps,
                batch=_batch())
    if family == "ldm":
        spec.update(unet=UNET, unet_state=unet_state, vae=VAE, vae_state=vae_state,
                    text=np.random.RandomState(3).standard_normal((1, 2, 16)).astype(np.float32))
    else:
        spec.update(unet=UNET2D, unet_state=unet_state)
    spec.update(extra)
    return spec


@functools.lru_cache(maxsize=None)
def _reference(optimizer, save=None, family="ldm"):
    """The one-process run of the train step, two steps (its step-1 state
    written to `save`)."""
    return ranks.train_steps(_spec((1, 1), family, optimizer=optimizer, save=save))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every multi-rank run of this file but the JAX cases' and the entry
    point's: the two-rank runs in one spawn of two ranks (each rank process
    pays its start once), the four-rank runs in one spawn of four beside
    it, both beside the one-process references that do not feed them:
    {job: (each rank's result)}. The TP2 resume reads the one-process
    step-1 checkpoint, so that one comes first."""
    root = tmp_path_factory.mktemp("two_ranks")
    one_ckpt, tp_ckpt = str(root / "one"), str(root / "tp2")
    _reference("adamw", one_ckpt)
    nan = _spec((2, 1), steps=1)
    nan["batch"]["normalized_rgb"][B // 2:, 0, 0, 0] = np.nan
    jobs = {
        "layers": ("layer_grads", (7,)),
        "adafactor shards": ("adafactor_shards", (11, 2)),
        **{f"{o} {m}": ("train_steps", (_spec(mesh, optimizer=o),))
           for o in ("adamw", "adafactor") for m, mesh in (("DP2", (2, 1)), ("TP2", (1, 2)))},
        "pixel DP2": ("train_steps", (_spec((2, 1), "pixel"),)),
        "non-finite rows": ("train_steps", (nan,)),
        "TP2 writes": ("train_steps", (_spec((1, 2), steps=1, save=tp_ckpt),)),
        "TP2 resumes": ("train_steps", (_spec((1, 2), steps=1, load=one_ckpt, first_step=1),)),
    }
    four_jobs = {f"{o} DP2xTP2": ("train_steps", (_spec((2, 2), optimizer=o),))
                 for o in ("adamw", "adafactor")}
    side, four = _Beside(ranks.jobs, 2, jobs), _Beside(ranks.jobs, 4, four_jobs)
    _reference("adafactor")
    _reference("adamw", family="pixel")
    out, out4 = side.result(), four.result()
    return {"tp_ckpt": tp_ckpt, "one_ckpt": one_ckpt,
            **{job: tuple(r[job] for r in out) for job in jobs},
            **{job: tuple(r[job] for r in out4) for job in four_jobs}}


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


def _rel(a, b, rtol, name):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=0, err_msg=name)


def _check_metrics(got, ref, label):
    for i, (g, r) in enumerate(zip(got, ref)):
        where = f"{label} step {i + 1}"
        np.testing.assert_array_equal(g["timesteps"], r["timesteps"], err_msg=where)
        _rel(g["loss"], r["loss"], 1e-5, f"{where} loss")
        _rel(g["per_sample_loss"], r["per_sample_loss"], 1e-5, f"{where} per-sample loss")
        _rel(g["grad_norm"], r["grad_norm"], 1e-4, f"{where} grad_norm")
        assert ("recon_mae" in g) == ("recon_mae" in r), where
        if "recon_mae" in r:
            _rel(g["recon_mae"], r["recon_mae"], 1e-5, f"{where} recon_mae")
        _rel(g["t_mean"], r["t_mean"], 1e-6, f"{where} t_mean")


def _check_params(ours, ref, steps, label):
    assert ours.keys() == ref.keys(), label
    diffs = {k: np.abs(np.asarray(ours[k], np.float64) - ref[k]).ravel() for k in ref}
    every = np.concatenate(list(diffs.values()))
    assert every.max() <= 2 * LR * steps, (label, every.max())
    rest = np.concatenate([d for k, d in diffs.items() if not k.endswith("to_k.bias")])
    assert np.quantile(rest, 0.999) <= 1e-3 * LR * steps, (label, np.quantile(rest, 0.999))


def _check_state(got, ref, steps, label, moment_rtol=1e-3):
    """Parameters by the train step's rule; the optimizer's tensors within
    `moment_rtol` of each tensor's largest element (outside the key
    biases); the counters and the sampler state."""
    _check_params(got["params"], ref["params"], steps, label)
    names = list(ref["params"])
    for key, value in ref["opt_state"].items():
        if not isinstance(value, list):
            np.testing.assert_array_equal(got["opt_state"][key], value, err_msg=f"{label} {key}")
            continue
        assert len(got["opt_state"][key]) == len(value), (label, key)
        for name, a, b in zip(names, got["opt_state"][key], value):
            assert a.shape == b.shape, (label, key, name, a.shape, b.shape)
            if name.endswith("to_k.bias"):
                continue
            scale = max(float(np.abs(b).max()), 1e-30)
            assert np.abs(a - b).max() <= moment_rtol * scale, (label, key, name)
    np.testing.assert_array_equal(got["sampler_state"]["loss_counts"],
                                  ref["sampler_state"]["loss_counts"], err_msg=label)
    _rel(got["sampler_state"]["loss_history"], ref["sampler_state"]["loss_history"], 1e-5,
         f"{label} sampler history")
    assert int(got["step"]) == int(ref["step"]) == steps, label


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #


def test_layer_gradients_match_the_unsharded_layer(two_ranks):
    """Each rank's weight gradient is its slice of the whole weight's; the
    output, the input's gradient and the (whole) biases' the unsharded
    layer's."""
    for rank, res in enumerate(two_ranks["layers"]):
        for kind, r in res.items():
            assert r["sharded"], kind
            for name, ref in r["ref"].items():
                got = r["ours"][name]
                assert got.shape == ref.shape, (rank, kind, name, got.shape, ref.shape)
                tol = 1e-5 * max(float(np.abs(ref).max()), 1.0)
                assert np.abs(got - ref).max() <= tol, (rank, kind, name,
                                                        float(np.abs(got - ref).max()))


# ---------------------------------------------------------------------- #
# the train step on a mesh against one process
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_dp2_and_tp2_match_one_process(two_ranks, optimizer):
    ref = _reference(optimizer)
    runs = list(zip(two_ranks[f"{optimizer} DP2"], two_ranks[f"{optimizer} TP2"]))
    for rank, (dp2, tp2) in enumerate(runs):
        _check_metrics(dp2["metrics"], ref["metrics"], f"DP2 rank {rank}")
        _check_state(dp2["state"], ref["state"], 2, f"DP2 rank {rank}")
        _check_metrics(tp2["metrics"], ref["metrics"], f"TP2 rank {rank}")
        _check_state(tp2["state"], ref["state"], 2, f"TP2 rank {rank}")
        assert tp2["sharded_leaves"] > 0 and dp2["sharded_leaves"] == 0
    # a rank holds half of a sharded weight
    local = runs[0][1]["local_shapes"]
    whole = ref["state"]["params"]
    assert any(local[n] != whole[n].shape for n in local)


def test_pixel_dp2_matches_one_process(two_ranks):
    ref = _reference("adamw", family="pixel")
    for rank, got in enumerate(two_ranks["pixel DP2"]):
        _check_metrics(got["metrics"], ref["metrics"], f"pixel DP2 rank {rank}")
        _check_state(got["state"], ref["state"], 2, f"pixel DP2 rank {rank}")


def test_dp2_x_tp2_on_four_ranks_matches_one_process(two_ranks):
    for opt in ("adamw", "adafactor"):
        ref = _reference(opt)
        runs = two_ranks[f"{opt} DP2xTP2"]
        assert len(runs) == 4
        for rank, got in enumerate(runs):
            _check_metrics(got["metrics"], ref["metrics"], f"DP2xTP2 {opt} rank {rank}")
            _check_state(got["state"], ref["state"], 2, f"DP2xTP2 {opt} rank {rank}")


def test_adafactor_takes_whole_parameters_on_a_mesh(two_ranks):
    """The chain on shards equals the chain on the whole tensors; a NaN in
    rank 1's shard of one gradient rejects the step on both ranks."""
    steps = 2
    for rank, res in enumerate(two_ranks["adafactor shards"]):
        (ref_steps, ref_state), (our_steps, our_state) = res["ref"], res["ours"]
        for i, ((rp, rn, rf), (op, on, of)) in enumerate(zip(ref_steps, our_steps)):
            assert rf == of == (i < steps), (rank, i)
            if i < steps:
                _rel(on, rn, 1e-6, f"rank {rank} norm {i}")
            for j, (a, b) in enumerate(zip(op, rp)):
                assert np.abs(a - b).max() <= 1e-6 * max(float(np.abs(b).max()), 1.0), (rank, i, j)
        # the rejected step left every shard as it was
        for a, b in zip(our_steps[steps][0], our_steps[steps - 1][0]):
            np.testing.assert_array_equal(a, b)
        for key in ("v_row", "v_col", "v"):
            for j, (a, b) in enumerate(zip(our_state[key], ref_state[key])):
                assert a.shape == b.shape, (key, j)
                assert np.abs(a - b).max() <= 1e-5 * max(float(np.abs(b).max()), 1e-30), (key, j)
        assert int(our_state["notfinite_count"]) == int(ref_state["notfinite_count"]) == 1


def test_non_finite_rows_on_one_rank_reject_the_update_everywhere(two_ranks):
    """NaN in rank 1's rows of the batch: the mean gradient is NaN on both
    ranks, both keep their parameters and moments bit for bit, as one
    process does on the same batch."""
    spec = _spec((1, 1), steps=1)
    spec["batch"]["normalized_rgb"][B // 2:, 0, 0, 0] = np.nan
    ref = ranks.train_steps(spec)
    before = spec["unet_state"]
    for rank, got in enumerate(list(two_ranks["non-finite rows"]) + [ref]):
        assert not np.isfinite(got["metrics"][0]["loss"]), rank
        for k, v in before.items():
            np.testing.assert_array_equal(got["state"]["params"][k], v, err_msg=f"{rank} {k}")
        assert all(not m.any() for m in got["state"]["opt_state"]["mu"]), rank
        assert int(got["state"]["opt_state"]["notfinite_count"]) == 1, rank
        assert int(got["state"]["opt_state"]["count"]) == 0, rank


# ---------------------------------------------------------------------- #
# checkpoints across topologies
# ---------------------------------------------------------------------- #


def test_checkpoints_resume_across_topologies(two_ranks):
    """TP2 writes its step-1 state gathered; one process resumes it. One
    process writes its step-1 state; TP2 resumes it. Both step-2 states are
    the one-process run's."""
    tp_ckpt, one_ckpt = two_ranks["tp_ckpt"], two_ranks["one_ckpt"]
    ref = _reference("adamw", one_ckpt)
    resumed = ranks.train_steps(_spec((1, 1), steps=1, load=tp_ckpt, first_step=1))
    # the TP2 checkpoint is the one-process file: the same keys and shapes
    tp_sd = torch.load(os.path.join(tp_ckpt, "state.pt"), weights_only=True)
    one_sd = torch.load(os.path.join(one_ckpt, "state.pt"), weights_only=True)
    assert {k: tuple(v.shape) for k, v in tp_sd["params"].items()} == {
        k: tuple(v.shape) for k, v in one_sd["params"].items()}
    assert [tuple(t.shape) for t in tp_sd["opt_state"]["mu"]] == [
        tuple(t.shape) for t in one_sd["opt_state"]["mu"]]
    _check_state(resumed["state"], ref["state"], 2, "TP2 checkpoint resumed in one process")
    for rank, from_one in enumerate(two_ranks["TP2 resumes"]):
        _check_state(from_one["state"], ref["state"], 2, f"one-process checkpoint on TP2 {rank}")


# ---------------------------------------------------------------------- #
# against the JAX step on a mesh
# ---------------------------------------------------------------------- #


def _jax_mesh_steps(steps=2):
    """The JAX `make_train_step` of the latent family jitted on
    make_mesh_dp_tp(2, 2): the batch sharded on the data axis, the state
    and the VAE by shard_state_tp / shard_params_tp on the model axis
    ((metrics a step, the params after them))."""
    from d3roma_tpu.config import TrainingConfig as JaxConfig
    from d3roma_tpu.parallel import make_mesh_dp_tp, shard_batch, shard_params_tp, shard_state_tp
    from d3roma_tpu.training import build_optimizer, create_train_state, make_train_step

    cfg = JaxConfig(**{k: v for k, v in _config(prediction=JAX_PREDICTION).items()
                       if k != "optimizer"})
    unet, params, vae, vae_params = _jax_models()
    tx = build_optimizer(cfg, 10)
    mesh = make_mesh_dp_tp(2, 2, jax.devices()[:4])
    state = shard_state_tp(create_train_state(cfg, params, 10, 0, tx=tx), mesh)
    vae_params = shard_params_tp(vae_params, mesh)
    text = np.random.RandomState(3).standard_normal((1, 2, 16)).astype(np.float32)
    step = jax.jit(make_train_step(
        cfg, lambda p, x, t, c: unet.apply({"params": p}, x, t, c), tx,
        cfg.schedule_config(train=True).tables(),
        lambda p, x, method: vae.apply({"params": p}, x, method=method), jnp.asarray(text)))
    batch = shard_batch({k: np.asarray(v) for k, v in _batch().items()}, mesh)
    metrics, compiled = [], None
    for i in range(steps):
        args = (state, batch, jax.random.fold_in(jax.random.PRNGKey(0), i), vae_params)
        if compiled is None:  # LLVM's cheapest level: the CPU compile in half the time
            compiled = step.lower(*args).compile({"xla_backend_optimization_level": 0})
        state, m = compiled(*args)
        # the state back on its input shardings, which the compiled step takes
        state = shard_state_tp(state, mesh)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def _jax_draws(steps=2):
    """The JAX step's draws for the global batch, a list a step."""
    lat = (B, HW[0] // 2, HW[1] // 2, 4)
    return [jax_step_draws(jax.random.fold_in(jax.random.PRNGKey(0), i), lat, "randn", B, T,
                           None, lat) for i in range(steps)]


@pytest.fixture(scope="module")
def jax_mesh():
    """The port's DP2 and TP2 runs on the JAX models' weights and draws
    (one spawn of two ranks), beside the JAX mesh step: (the JAX run, the
    port's weights after it, {mesh: each rank's result})."""
    from d3roma_tpu_torch.models import flax_unet_to_torch

    draws, states = _jax_draws(), _jax_states()
    side = _Beside(ranks.jobs, 2, {
        k: ("train_steps", (_spec(mesh, draws=draws, prediction=JAX_PREDICTION, states=states),))
        for k, mesh in JAX_MESHES.items()})
    jm, jparams = _jax_mesh_steps()
    out = side.result()
    return jm, _np(flax_unet_to_torch(jparams)), {k: tuple(r[k] for r in out) for k in JAX_MESHES}


@pytest.mark.parametrize("kind", list(JAX_MESHES), ids=["dp2-latent", "tp2-latent"])
def test_mesh_step_matches_jax_on_a_mesh(jax_mesh, kind):
    jm, ref, runs = jax_mesh
    for rank, got in enumerate(runs[kind]):
        _check_metrics(got["metrics"], jm, f"{kind} rank {rank} against JAX")
        _check_params(got["state"]["params"], ref, 2, f"{kind} rank {rank} against JAX")


# ---------------------------------------------------------------------- #
# the entry point
# ---------------------------------------------------------------------- #

ENTRY = ["task=train_hiss", "task.cond_channels=rgb+raw", "task.camera_resolution=64x36",
         "task.image_size=[32,48]", "task.divis_by=16", "task.train_batch_size=2",
         "task.eval_batch_size=2", "task.eval_num_batch=1", "task.num_epochs=1",
         "task.val_every_global_steps=2", "task.save_model_epochs=1",
         "task.num_inference_timesteps=2", "task.num_intermediate_images=1",
         "task.block_out_channels=[16,32]", "seed=3"]

# one rank of the entry point as torchrun starts it, every path it opens
# for writing (or makes) recorded by an audit hook
_RANK = r"""
import json, os, runpy, sys
written = []

def hook(event, args):
    if event == "open" and args[1] is not None and any(c in str(args[1]) for c in "wax+"):
        written.append(str(args[0]))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove"):
        written.append(str(args[0]))

sys.addaudithook(hook)
sys.argv = ["d3roma_tpu_torch.train"] + json.loads(sys.argv[1])
try:
    runpy.run_module("d3roma_tpu_torch.train", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
finally:
    sys.stdout.write("WROTE " + json.dumps(written) + "\n")
"""


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    from d3roma_tpu_torch.synthetic.procedural import SceneConfig, generate_dataset

    root = tmp_path_factory.mktemp("train_parallel")
    cfg = SceneConfig(height=36, width=64)
    generate_dataset(str(root / "datasets" / "HISS"), 8, split="train", config=cfg)
    generate_dataset(str(root / "datasets" / "HISS"), 2, split="val", config=cfg, seed=1)
    return root


def _steps(log_path):
    steps = []
    for line in Path(log_path).read_text().splitlines():
        parts = line.split()
        if "loss" in parts and "grad_norm" in parts and "step" in parts:
            steps.append((int(parts[parts.index("step") + 1]),
                          float(parts[parts.index("loss") + 1])))
    return steps


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file()
                  and "tb" not in p.parts)


def _outputs(paths):
    """The paths a rank wrote other than the system's scratch (the temp
    directory, /dev/null) and the port's build cache."""
    scratch = (tempfile.gettempdir(), os.devnull)
    return [p for p in paths if not p.startswith(scratch) and "_build" not in p]


@pytest.fixture(scope="module")
def entry_runs(frames, tmp_path_factory):
    """The entry point on two ranks (torchrun's environment, each a
    subprocess recording what it wrote), on three (spawned ranks, `train`
    given max_steps=2) and in one process, side by side: (the one-process
    output, the two ranks' output, their (stdout, stderr), the three ranks'
    output, their results)."""
    from d3roma_tpu_torch import train as entry

    root = tmp_path_factory.mktemp("entry")
    one, out, w3 = str(root / "one"), str(root / "dp2"), str(root / "w3")
    three = _Beside(ranks.entry_point, 3, str(frames),
                    ["--device", "cpu"] + ENTRY + [f"task.output_dir={w3}"], 2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = json.dumps(["--device", "cpu"] + ENTRY + [f"task.output_dir={out}"])
    env = dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, argv], cwd=frames,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    cwd = os.getcwd()
    os.chdir(frames)
    try:
        assert entry.main(["--device", "cpu"] + ENTRY + [f"task.output_dir={one}"]) == 0
    finally:
        os.chdir(cwd)
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    return one, out, outs, w3, three.result()


def test_entry_point_on_two_ranks_writes_rank_0s_files_only(entry_runs):
    one, out, outs, _, _ = entry_runs
    wrote = [json.loads(o.split("WROTE ", 1)[1].splitlines()[0]) for o, _ in outs]
    # rank 1 made and opened nothing for writing but its libraries' scratch
    assert _outputs(wrote[1]) == [], wrote[1]
    assert any(w.startswith(out) for w in wrote[0])
    assert "[rank 1]" in outs[1][1]
    assert "mesh DP2 x TP1, data 1, model 0, backend gloo" in outs[1][1]
    assert _files(out) == _files(one)
    ours, ref = _steps(Path(out, "train.log")), _steps(Path(one, "train.log"))
    assert [s for s, _ in ours] == [s for s, _ in ref] == [1, 2, 3, 4]
    _rel([l for _, l in ours], [l for _, l in ref], 1e-5, "the entry point's losses")
    assert "eval[0] @2:" in Path(out, "train.log").read_text()


def test_a_world_of_three_at_batch_2_leaves_one_rank_idle(entry_runs):
    *_, out, codes = entry_runs
    assert [c["code"] for c in codes] == [0, 0, 0]
    assert codes[2]["idle"] and not codes[0]["idle"] and not codes[1]["idle"]
    assert _outputs(codes[2]["wrote"]) == [] and _outputs(codes[1]["wrote"]) == []
    assert [s for s, _ in _steps(Path(out, "train.log"))] == [1, 2]
    assert "mesh DP2 x TP1" in Path(out, "train.log").read_text()
    assert os.path.exists(os.path.join(out, "checkpoints", "last", "state.pt"))
