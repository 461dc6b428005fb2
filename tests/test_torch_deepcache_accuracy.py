"""The DeepCache accuracy sweep (`python -m d3roma_tpu_torch.deepcache_accuracy`)
against the JAX package's `scripts/deepcache_accuracy.py`, and the gate on
the port's bench default.

- `parse_cfg` gives the JAX script's results on every case of
  tests/test_bench_select.py::test_sweep_parse_cfg_grammar (the JAX module
  loaded as that test loads it) and refuses what it refuses;
- `table_row` gives the JAX `_row`'s columns, drifts included, on the same
  metric dicts;
- the rows bf16:1, bf16:2 and int8:1 of a two-frame sweep on a tiny latent
  model (torch_port_utils' TINY_UNET and TINY_VAE, a JAX pipeline
  directory, two DDIM steps) give the JAX `evaluate_dataset`'s metrics on
  the same weights, the row's seed 1234 and the JAX key schedule replayed as
  explicit noise (tests/test_torch_evaluate.py's `_Replay`); the int8 row
  replays the JAX calibration's scales, loaded from the sweep's scale
  cache, with the JAX int8 kernels in interpret mode. Tolerances, relative,
  per metric: bf16 rows 5e-3 (both run bf16 weights and activations, whose
  roundings fall in other places: the bf16 noise, ~1e-2 of the images'
  max, averaged over the frames' pixels; measured 1.2e-3 at most), the
  int8 row 2e-2 (every int8 op is exact per op, but a last-place difference
  before a quantization moves a value by one quantum: the int8 noise, 3e-2
  mean on the images, tests/test_torch_quant_modes.py; measured 4.2e-3);
- a pin kind that selects no call raises `EmptyPins` (under
  `fast_inference("throughput")` the self-attention takes the whole-row
  kernel, which takes no scale: kind "attn" has no call), and the sweep
  lists the row under "refused";
- row files resume: a second sweep reads every row from its file; a row
  file of another checkpoint step is evaluated again, and rows of another
  seed have files of their own and draw from that seed;
- the VAE ceiling (the frozen VAE's round trip of the ground truth through
  the rows' eval) gives the JAX eval loop's metrics for the JAX VAE's round
  trip on the same weights and frames, both in fp32, within 1e-4 relative
  (fp32 sums in other orders: measured 1.3e-6; the round trip's images
  agree to 4e-5 of their max). In bf16 the tiny random VAE's rounding alone moves the images
  by 1e-2 on average, which would hide a wrong round trip;
- `load_unet` takes the trained UNet and the global step from a checkpoint
  whichever optimizer wrote it;
- the gate: `d3roma_tpu_torch/bench.py`'s DEFAULT_DEEPCACHE has a
  `combined_int8` row in `docs/deepcache_accuracy_torch.json` (measured on
  the card) with |depth_rel_drift_pct| under the 1% parity bar.
"""

import importlib.util
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.config import compose as jax_compose
from d3roma_tpu.data import fetch_dataloader as jax_fetch
from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models import decode_latent as jax_decode_latent
from d3roma_tpu.models import encode_disp_to_latent as jax_encode_disp
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import InputPadder as JaxInputPadder
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.pipelines import create_sampler_spec as jax_sampler_spec
from d3roma_tpu.pipelines.sampling import latent_decode_images as jax_decode_images
from d3roma_tpu.training.train_loop import _preprocess_eval
from d3roma_tpu_torch import deepcache_accuracy as dca
from d3roma_tpu_torch.config import compose
from d3roma_tpu_torch.data import val_loaders
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, create_sampler_spec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from torch_port_utils import TINY_UNET, TINY_VAE, jax_noise_schedule, randn, randomize_, \
    state_dict_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = BATCH = 2
OVERRIDES = [f"task.eval_batch_size={BATCH}", "task.eval_num_batch=1",
             "task.camera_resolution=64x36", "task.image_size=[32,64]",
             "task.num_inference_timesteps=2", "task.ch_bounds=[8.0]"]
ROWS = {("bf16", "1"): 5e-3, ("bf16", "2"): 5e-3, ("int8", "1"): 2e-2}
METRICS = (("disp", "epe"), ("disp", "d1"), ("depth", "rel"), ("depth", "rmse"),
           ("depth", "mae"))
GRAMMAR = ("1", "2d2", "FSFSFSFSFF", "FSFSFSFSFFd2", "1q0.999", "1m1.0", "1pattn", "2d2pconv",
           "fsfsfsfsff", "3d1q0.99m1.1pgeglu", "FSFSFSFSFFpdot")


@pytest.fixture(scope="module")
def jax_script(tmp_path_factory):
    """scripts/deepcache_accuracy.py loaded as tests/test_bench_select.py
    loads it (DC_RUN a temporary directory, the working directory restored)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DC_RUN", str(tmp_path_factory.mktemp("dc_run")))
    mp.setenv("DC_KS", "1")
    cwd = os.getcwd()
    spec = importlib.util.spec_from_file_location(
        "dc_sweep", os.path.join(REPO, "scripts", "deepcache_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.chdir(cwd)
        mp.undo()
    return mod


@pytest.mark.parametrize("cfg", GRAMMAR)
def test_parse_cfg_matches_jax(jax_script, cfg):
    assert dca.parse_cfg(cfg) == jax_script.parse_cfg(cfg)


@pytest.mark.parametrize("cfg", ("1pbogus", "", "2x", "1q1.5", "d2"))
def test_parse_cfg_refuses_what_jax_refuses(jax_script, cfg):
    with pytest.raises(AssertionError):
        jax_script.parse_cfg(cfg)
    with pytest.raises(ValueError):
        dca.parse_cfg(cfg)


def _metrics(seed):
    rs = np.random.RandomState(seed)
    return {"disp": {"epe": float(rs.uniform(1, 50)), "d1": float(rs.rand())},
            "depth": {"rel": float(rs.rand()), "rmse": float(rs.uniform(0.1, 2)),
                      "mae": float(rs.uniform(0.1, 2))}}


def test_table_row_matches_jax(jax_script):
    exact, base, row = _metrics(0), _metrics(1), _metrics(2)
    zero = dict(_metrics(3), depth=dict(_metrics(3)["depth"], rel=0.0))
    for m, baselines in ((exact, {"": exact}), (row, {"": exact}),
                         (row, {"": exact, "_vs_int8": base}),
                         (base, {"": exact, "_vs_int8": base}), (row, {"": zero})):
        assert dca.table_row(m, baselines) == jax_script._row(m, baselines)
    assert "depth_rel_drift_pct" not in dca.table_row(row, {"": zero})


def test_wanted_rows_skip_the_int8_levers_in_bf16():
    rows = dca.wanted_rows(["bf16", "int8"], ["1", "2d2", "1q0.999", "1m1.0", "1pconv"])
    assert rows == [("bf16", "1"), ("bf16", "2d2"), ("int8", "1"), ("int8", "2d2"),
                    ("int8", "1q0.999"), ("int8", "1m1.0"), ("int8", "1pconv")]
    for modes, ks in ((["bf16"], ["2"]), (["int8"], ["1"]), (["bf16", "fp8"], ["1"])):
        with pytest.raises(ValueError):
            dca.wanted_rows(modes, ks)


# ---------------------------------------------------------------------- #
# rows against the JAX evaluate_dataset
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A JAX pipeline directory of the tiny latent model and two val frames."""
    root = tmp_path_factory.mktemp("deepcache_accuracy")
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
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(8.0,),
                                 ch_gammas=(1.0,))).save_pretrained(str(root / "pipe"))
    generate_dataset(str(root / "datasets" / "HISS"), FRAMES, "val",
                     SceneConfig(height=36, width=64), seed=dca.VAL_SEED)
    return root


class _Replay:
    """The port's pipeline drawing the JAX package's noise: each call takes
    the next JAX key and passes its initial latents and step noise."""

    def __init__(self, pipe, keys, factor=2):
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


def _jax_row(tree, mode, cfg, monkeypatch):
    """The JAX script's row (its child's pipeline per mode and config, its
    evaluate_dataset call) on the tiny pipeline; (metrics, act_scales)."""
    monkeypatch.chdir(tree)
    jcfg = jax_compose(dca.CAPSTONE + OVERRIDES).task
    pipe = JaxPipeline.from_pretrained(str(tree / "pipe")).replace_sampler(
        jax_sampler_spec(jcfg, train=False)).half_precision()
    loader = jax_fetch(jcfg, seed=0)[1][0]
    preprocess = partial(_preprocess_eval, config=jcfg, normalizer=JaxNormalizer.from_config(jcfg))
    sched, depth, _, _, _ = dca.parse_cfg(cfg)
    if mode == "int8":
        monkeypatch.setenv("D3ROMA_PALLAS_INTERPRET", "1")
        pipe = pipe.fast_inference("throughput")
        b = preprocess(next(iter(loader)))
        pipe = pipe.calibrate(jax.random.PRNGKey(dca.CALIB_SEED),
                              [dict(rgb_images=b["normalized_rgb"], sim_disp=b["sim_disp"])],
                              cond_channels=jcfg.cond_channels,
                              num_inference_steps=jcfg.num_inference_timesteps)
    if sched > 1:
        pipe = pipe.deepcache(sched, depth=depth)
    m, _ = jax_evaluate(jcfg, pipe, loader, jax.random.PRNGKey(dca.EVAL_SEED),
                        preprocess=preprocess, max_batches=jcfg.eval_num_batch,
                        dataset_name="HISS")
    scales = None if pipe.act_scales is None else {
        k: np.asarray(v, np.float64).tolist() for k, v in pipe.act_scales.items()}
    monkeypatch.delenv("D3ROMA_PALLAS_INTERPRET", raising=False)
    return m, scales


def _port_sweep(tree, run, half=True):
    """A Sweep over the port's load of the same directory (in bf16, as the
    sweep loads it, unless `half` is False), drawing the JAX key schedule of
    the row's evaluate_dataset call."""
    config = compose(dca.CAPSTONE + OVERRIDES).task
    base = GuidedLatentDiffusionPipeline.from_pretrained(str(tree / "pipe"), device="cpu")
    base.replace_sampler(create_sampler_spec(config, train=False))
    if half:
        base.half_precision()
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        loader = val_loaders(config)[0]
    finally:
        os.chdir(cwd)
    os.makedirs(run, exist_ok=True)
    os.symlink(tree / "datasets", run / "datasets")  # the sweep reads its frames under run
    return dca.Sweep(str(run), config, base, loader, 0, BATCH)


@pytest.fixture
def replayed(monkeypatch):
    inner = dca._evaluate

    def evaluate(config, pipe, loader, preprocess, seed=dca.EVAL_SEED, max_batches=None):
        keys = [jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 0), 0)]
        return inner(config, _Replay(pipe, keys), loader, preprocess, seed, max_batches)

    monkeypatch.setattr(dca, "_evaluate", evaluate)


@pytest.mark.parametrize("mode,cfg", sorted(ROWS))
def test_row_matches_jax(tree, replayed, monkeypatch, mode, cfg):
    ref, scales = _jax_row(tree, mode, cfg, monkeypatch)
    sweep = _port_sweep(tree, tree / f"rows_{mode}_{cfg}")
    if scales is not None:  # the JAX calibration's table, from the sweep's scale cache
        with open(sweep._scales_path(cfg), "w") as f:
            json.dump(scales, f)
    ours = sweep.row(mode, cfg)
    assert ours["_checkpoint_step"] == 0 and ours["_device"] == "cpu"
    for space, met in METRICS:
        np.testing.assert_allclose(ours[space][met], float(ref[space][met]),
                                   rtol=ROWS[(mode, cfg)], atol=0, err_msg=f"{space}/{met}")


def test_empty_pins_raise_and_rows_resume(tree, replayed, monkeypatch, tmp_path):
    sweep = _port_sweep(tree, tmp_path / "run")
    pipe = sweep.pipeline("int8", "1")
    with pytest.raises(dca.EmptyPins):
        sweep.pins(pipe, "attn")
    assert all(sweep.pins(pipe, "conv").values())
    doc = sweep.table(["1", "1pattn"], ["bf16", "int8"], FRAMES)
    assert set(doc["refused"]) == {"int8:1pattn"}
    assert set(doc["bf16"]) == {"1"} and set(doc["combined_int8"]) == {"1"}
    assert doc["checkpoint_step"] == 0 and doc["device"] == "cpu"
    assert not os.path.exists(sweep.row_path("int8", "1pattn"))
    # a second sweep reads every row from its file
    with open(sweep.row_path("int8", "1")) as f:
        row = json.load(f)
    row["depth"]["rel"] *= 1.5
    with open(sweep.row_path("int8", "1"), "w") as f:
        json.dump(row, f)

    def no_eval(*args):
        raise AssertionError("a row with a file was evaluated again")

    monkeypatch.setattr(dca, "_evaluate", no_eval)
    again = dca.Sweep(sweep.run, sweep.config, sweep.base, sweep.loader, 0, BATCH)
    again_doc = again.table(["1"], ["bf16", "int8"], FRAMES)
    assert again_doc["combined_int8"]["1"]["depth_rel"] == round(row["depth"]["rel"], 4)
    assert again_doc["bf16"] == doc["bf16"]


def test_rows_of_another_step_or_seed(tree, monkeypatch, tmp_path):
    seeds = []

    def evaluate(config, pipe, loader, preprocess, seed=dca.EVAL_SEED, max_batches=None):
        seeds.append(seed)
        return {"disp": {"epe": float(len(seeds))},
                "depth": {"rel": 0.5, "rmse": 1.0, "mae": 0.25}}

    monkeypatch.setattr(dca, "_evaluate", evaluate)
    sweep = _port_sweep(tree, tmp_path / "run")
    assert sweep.row("bf16", "1")["disp"]["epe"] == 1.0 and seeds == [dca.EVAL_SEED]
    assert sweep.row("bf16", "1")["disp"]["epe"] == 1.0 and len(seeds) == 1  # its file
    # a later checkpoint in the same directory evaluates the row again
    later = dca.Sweep(sweep.run, sweep.config, sweep.base, sweep.loader, 5, BATCH)
    m = later.row("bf16", "1")
    assert m["_checkpoint_step"] == 5 and m["disp"]["epe"] == 2.0 and len(seeds) == 2
    # another seed: its own file, its own draws, named in the table
    other = dca.Sweep(sweep.run, sweep.config, sweep.base, sweep.loader, 5, BATCH, seed=7)
    assert os.path.basename(other.row_path("bf16", "1")) == "dc_row_bf16_1_s7.json"
    assert os.path.basename(later.row_path("bf16", "1")) == "dc_row_bf16_1.json"
    assert other.row("bf16", "1")["disp"]["epe"] == 3.0 and seeds[-1] == 7
    doc = dca.build_doc({("bf16", "1"): m}, ["1"], ["bf16"], FRAMES, 2, seed=7)
    assert doc["eval_seed"] == 7 and "eval_seed" not in dca.build_doc(
        {("bf16", "1"): m}, ["1"], ["bf16"], FRAMES, 2)


class _JaxRoundTrip:
    """The VAE ceiling's stand-in in the JAX eval loop: the JAX VAE's round
    trip of the ground truth kept by `take`, padded and clamped as the
    port's `_RoundTrip` does."""

    def __init__(self, pipe, divis_by):
        self.vae, self.apply = pipe.vae, pipe._vae_apply(pipe.vae_params)
        self.guidance, self.divis_by, self.gt = JaxGuidance(flow_guidance_weight=0.0), divis_by, None

    def take(self, batch):
        self.gt = batch["normalized_disp"]
        return batch

    def __call__(self, key, **_):
        (gt,) = JaxInputPadder(self.gt.shape, divis_by=self.divis_by).pad(self.gt)
        z = jax_encode_disp(self.apply, gt)
        return jax_decode_images(lambda x: jax_decode_latent(self.apply, x), z[None])


def test_vae_ceiling_matches_jax(tree, monkeypatch, tmp_path):
    monkeypatch.chdir(tree)
    jcfg = jax_compose(dca.CAPSTONE + OVERRIDES).task
    pipe = JaxPipeline.from_pretrained(str(tree / "pipe"))
    loader = jax_fetch(jcfg, seed=0)[1][0]
    preprocess = partial(_preprocess_eval, config=jcfg, normalizer=JaxNormalizer.from_config(jcfg))
    trip = _JaxRoundTrip(pipe, jcfg.divis_by)
    ref, _ = jax_evaluate(jcfg, trip, loader, jax.random.PRNGKey(dca.EVAL_SEED),
                          preprocess=lambda b: trip.take(preprocess(b)),
                          max_batches=jcfg.eval_num_batch, dataset_name="HISS")
    monkeypatch.chdir(tmp_path)
    sweep = _port_sweep(tree, tmp_path / "run", half=False)
    ours = sweep.vae_ceiling()
    assert ours["_device"] == "cpu"
    for space, met in METRICS:
        np.testing.assert_allclose(ours[space][met], float(ref[space][met]), rtol=1e-4, atol=0,
                                   err_msg=f"{space}/{met}")
    doc = sweep.table(["1"], ["bf16"], FRAMES)  # the table carries it, from its file
    assert doc["vae_ceiling"] == dca.table_row(ours, {})


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_load_unet_reads_the_checkpoint_of_either_optimizer(tmp_path, optimizer):
    """The sweep takes the trained UNet from checkpoints/last whatever
    optimizer wrote it, and the checkpoint's global step."""
    from d3roma_tpu_torch.training import StepCounter, build_optimizer, create_train_state
    from d3roma_tpu_torch.training import save_state

    config = compose(dca.CAPSTONE + [f"task.optimizer={optimizer}"]).task
    unet = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 3)
    state = create_train_state(config, unet, 4, optimizer=build_optimizer(
        config, 4, list(unet.parameters())))
    counter = StepCounter()
    for _ in range(7):
        counter.tick()
    save_state(str(tmp_path / "last"), state, counter)
    fresh = randomize_(UNet2DCondition(**TINY_UNET, device="cpu"), 4)
    assert dca.load_unet(str(tmp_path / "last"), fresh) == 7
    for k, v in unet.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_default_deepcache_is_accuracy_gated():
    """The port's bench default DeepCache schedule (the JAX bench's, 2d2)
    has a measured combined-int8 row on the card inside the 1% AbsRel
    parity bar, as tests/test_bench_select.py holds the JAX bench's to
    docs/deepcache_accuracy.json."""
    spec = importlib.util.spec_from_file_location(
        "port_bench", os.path.join(REPO, "d3roma_tpu_torch", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    cfg_key = bench.DEFAULT_DEEPCACHE
    if cfg_key in ("1", "1d1"):
        return  # exact numerics: nothing to gate
    with open(os.path.join(REPO, "docs", "deepcache_accuracy_torch.json")) as f:
        doc = json.load(f)
    assert doc["device"].startswith("NVIDIA") and doc["checkpoint_step"] > 0
    rows = doc["combined_int8"]
    assert cfg_key in rows, f"DEFAULT_DEEPCACHE={cfg_key} has no combined-int8 row"
    assert abs(rows[cfg_key]["depth_rel_drift_pct"]) < 1.0, rows[cfg_key]
