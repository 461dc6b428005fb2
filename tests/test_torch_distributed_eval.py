"""Data-parallel evaluation of the port against the JAX package's
(tests/test_distributed_eval.py's case): the tiny pixel pipeline (my_ddpm,
4 steps, 2 intermediate images, SSI least squares) on one batch of 3
distinct samples, padded to 4 for two data ranks (`pad_batch_to_devices`
marks the padded row `sample_valid` 0), each rank on its 2 rows (the port:
two spawned processes of a gloo group, `slice_process_local` +
`shard_batch`, the per-sample metrics gathered across the data axis; JAX:
`shard_batch` over 2 of the virtual CPU devices), both replaying the JAX
key's noise (each port rank its rows of the 4-row draw).

The aggregate metrics agree within METRIC_RTOL; only the 3 real samples
enter the averager, in both packages; the result is the mean over the real
rows, which the padded duplicate (distinct content) would have moved."""

import dataclasses

import jax
import numpy as np
import pytest

from d3roma_tpu.config import TrainingConfig as JaxConfig
from d3roma_tpu.evaluation import eval_batch as jax_eval_batch
from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
from d3roma_tpu.parallel import make_mesh, pad_batch_to_devices, shard_batch
from d3roma_tpu.training import build_models, create_pipeline
import torch_port_utils as U

METRIC_RTOL = 1e-4
CONFIG = dict(
    name="dist", ldm=False, depth_channels=1, cond_channels="rgb+raw",
    camera_resolution="96x64", image_size=(32, 64), divis_by=32,
    num_train_timesteps=8, num_inference_timesteps=4,
    num_intermediate_images=2, prediction_type="sample",
    noise_strategy="randn", sampler="my_ddpm",
    ssi=True, safe_ssi=False, prediction_space="disp",
    train_dataset=["Real_train_fxm"], eval_dataset=["Real_test_fxm"],
    dataset_weight=[1], train_batch_size=2, eval_batch_size=3,
    eval_num_batch=1, num_epochs=1, gradient_accumulation_steps=1,
    learning_rate=1e-4, lr_warmup_steps=0, lr_scheduler="constant",
    val_every_global_steps=1000, save_model_epochs=1,
    block_out_channels=(8, 16), clip_sample=True,
    num_inference_rounds=1,
)


def _batch_np(b, h=32, w=64, seed=0):
    rng = np.random.default_rng(seed)
    # distinct per-row content so a duplicated tail row shifts the mean
    disp = np.stack([rng.uniform(5 + 15 * i, 15 + 15 * i, (h, w, 1)).astype(np.float32)
                     for i in range(b)])
    return {
        "raw_disp": disp,
        "normalized_disp": ((disp / 64 - 0.5) * 2).astype(np.float32),
        "sim_disp": ((disp / 64 - 0.5) * 2).astype(np.float32),
        "normalized_rgb": np.zeros((b, h, w, 3), np.float32),
        "left_image": np.zeros((b, h, w, 3), np.float32),
        "right_image": np.zeros((b, h, w, 3), np.float32),
        "mask": np.ones((b, h, w, 1), np.float32),
        "raw_depth": (400.0 / np.maximum(disp, 1e-3)).astype(np.float32),
        "fxb": np.full((b,), 400.0, np.float32),
    }


def test_dp2_eval_of_a_padded_batch_matches_jax(tmp_path):
    cfg = JaxConfig(**CONFIG)
    pipeline = create_pipeline(cfg, build_models(cfg, jax.random.PRNGKey(0)))
    pipeline.save_pretrained(str(tmp_path / "pixel"))
    raw = _batch_np(3)
    mesh = make_mesh(jax.devices()[:2])

    def prep(b):
        return shard_batch(pad_batch_to_devices(b, 2), mesh)

    key = jax.random.PRNGKey(7)
    ref, ref_stat = jax_evaluate(cfg, pipeline, [raw], key, preprocess=prep, max_batches=1)
    # the per-row metrics of the same padded run, the duplicate included
    _, (md, _), _, _, _ = jax_eval_batch(cfg, pipeline, prep(raw), jax.random.fold_in(key, 0))
    assert md.shape[0] == 4

    call_key = jax.random.fold_in(jax.random.fold_in(key, 0), 0)
    x_init, noise = U.jax_noise_schedule(call_key, (4, 32, 64, 1), cfg.num_inference_timesteps)
    outs = U.run_ranks(U.dp_eval_ranks, 2, dataclasses.asdict(cfg), str(tmp_path / "pixel"),
                       raw, x_init, noise)
    for metrics, epe, count in outs:
        assert count == len(ref_stat) == 3  # the padded row never enters the averager
        np.testing.assert_allclose(epe, md[:3, 0], rtol=METRIC_RTOL)
        assert metrics.keys() == ref.keys() == {"disp", "depth"}
        for group in ref:
            for k, v in ref[group].items():
                assert metrics[group][k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-6), (group, k)
        assert metrics["disp"]["epe"] == pytest.approx(float(np.mean(md[:3, 0])), rel=METRIC_RTOL)
    # the duplicated tail row would have moved the mean
    assert abs(float(np.mean(md[:, 0])) - float(np.mean(md[:3, 0]))) > 1e-3
