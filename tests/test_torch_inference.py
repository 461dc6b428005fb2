"""The port's `D3RoMa` (d3roma_tpu_torch/inference.py) against the JAX
package's on the CPU, on pipeline directories the JAX package saves (the
tiny latent model of torch_port_utils, TINY_UNET at 12 input channels for
rgb+raw and 16 for left+right+raw, TINY_VAE), at 32x64 from 36x64 frames
(both resize them), 2 DDIM steps. The port's pipeline draws the JAX keys
that the JAX `D3RoMa` splits, one a call (`_Replay`), so both see the same
noise:

- `infer_with_rgb_raw`, `infer` (left+right+raw) and
  `infer_with_rgb_raw_batch` (two frames) within DEPTH_RTOL of the JAX
  depth, the disparity's relative tolerance of the evaluate parity test
  (fp32 pipelines whose images agree to ~1e-6), carried to depth by
  depth = fxb / disparity;
- two rounds: the depth and `last_uncertainty` (the std of the normalized
  rounds) within the same tolerance, on SSI least squares, and the server's
  warm frame (black, a constant 1 m) through both packages under SSI:
  finite, and equal within the same tolerance;
- two intermediate images under SSI RANSAC (`safe_ssi`), the port's subsets
  the JAX key's: the depth within the same tolerance and the logged metrics
  within METRIC_RTOL (means over the frame's pixels);
- a batch of 3 distinct frames equal to each frame run alone on its own
  slice of the same noise (no mixing across frames), within
  BATCH_VS_SINGLE_RTOL x the depth's max;
- `_prep_rgb_raw` bit-equal to the JAX one (OpenCV's resize);
- the refusals: an unreleased variant, a missing pipeline directory,
  `task.tensor_parallel=2` outside a process group, `task.aot_cache`;
- the port's HTTP server in front of the port's `D3RoMa`: three concurrent
  frames at 0.5 / 1 / 1.5 m under SSI, each answer at its own frame's scale;
- the demo (`python -m d3roma_tpu_torch.demo --device cpu`) against the
  repository's inference.py on the same directory: `raw.ply` byte-equal,
  `raw_aligned.png`'s pixels equal (the two PNG encoders compress
  differently), and `pred.ply`'s point count the count of the non-zero
  predicted depths."""

import io
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.inference import D3RoMa as JaxD3RoMa
from d3roma_tpu.models import AutoencoderKL as JaxVAE
from d3roma_tpu.models import UNet2DCondition as JaxUNet
from d3roma_tpu.models.torch_import import unet_torch_to_flax, vae_torch_to_flax
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.ops import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxPipeline
from d3roma_tpu.pipelines import SamplerSpec as JaxSamplerSpec
from d3roma_tpu.utils.camera import Realsense as JaxRealsense
import d3roma_tpu_torch.inference as port_inference
from d3roma_tpu_torch.inference import D3RoMa
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.streaming import InferenceHTTPServer
from d3roma_tpu_torch.utils.camera import Realsense
from torch_port_utils import TINY_UNET, TINY_VAE, jax_noise_schedule, randn, randomize_, \
    state_dict_numpy

H, W = 32, 64
FRAME_HW = (36, 64)
STEPS = 2
DEPTH_RTOL = 1e-4
METRIC_RTOL = 1e-4
BATCH_VS_SINGLE_RTOL = 1e-5
COMMON = [f"task.image_size=[{H},{W}]", f"task.num_inference_timesteps={STEPS}",
          "task.num_intermediate_images=1"]


def _save_jax_pipe(path, in_channels, seed):
    unet = randomize_(UNet2DCondition(**dict(TINY_UNET, in_channels=in_channels),
                                      device="cpu"), seed)
    vae = randomize_(AutoencoderKL(**TINY_VAE, device="cpu"), seed + 1)
    JaxPipeline(
        unet=JaxUNet(**dict(TINY_UNET, in_channels=in_channels)),
        unet_params=jax.tree_util.tree_map(jnp.asarray,
                                           unet_torch_to_flax(state_dict_numpy(unet))),
        vae=JaxVAE(**TINY_VAE),
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_torch_to_flax(state_dict_numpy(vae))),
        text_embed=jnp.asarray(randn(seed + 2, 1, 2, TINY_UNET["cross_attention_dim"])),
        spec=JaxSamplerSpec("my_ddim", JaxScheduleConfig(num_train_timesteps=1000)),
        guidance=JaxGuidance(flow_guidance_weight=0.0),
        normalizer=JaxNormalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                                 ch_gammas=(1.0,))).save_pretrained(str(path))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    _save_jax_pipe(root / "rgb_raw", 12, 0)
    _save_jax_pipe(root / "lr_raw", 16, 10)
    return root


class _Replay:
    """The port's pipeline drawing the JAX package's noise: each call takes
    the next key and passes its initial latents and step noise (the tiny
    VAE halves each side)."""

    def __init__(self, pipe, keys):
        self.pipe, self.keys = pipe, list(keys)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        ref = next(kw[k] for k in ("rgb_images", "left_images") if kw.get(k) is not None)
        b, h, w, _ = ref.shape
        x_init, noise = jax_noise_schedule(self.keys.pop(0), (b, h // 2, w // 2, 4),
                                           kw["num_inference_steps"])
        return self.pipe(latents=torch.from_numpy(x_init),
                         step_noise=[torch.from_numpy(n) for n in noise], **kw)


def _jax_call_keys(n, seed=0):
    """The keys the JAX D3RoMa hands its pipeline, one a call."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(sub)
    return out


def _pair(tree, variant, extra, calls):
    preset = "task=eval_ldm_mixed_rgb+raw" if variant == "rgb+raw" else "task=eval_ldm_mixed"
    pipe = tree / ("rgb_raw" if variant == "rgb+raw" else "lr_raw")
    ov = [preset, f"task.resume_pretrained={pipe}"] + COMMON + list(extra)
    ref = JaxD3RoMa(ov, JaxRealsense.default_real("fxm"), variant=variant)
    ours = D3RoMa(ov, Realsense.default_real("fxm"), variant=variant, device="cpu")
    ours.pipeline = _Replay(ours.pipeline, _jax_call_keys(calls))
    return ref, ours


def _frame(seed, scale=1.0, hw=FRAME_HW):
    rs = np.random.RandomState(seed)
    rgb = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    depth = (scale * np.linspace(0.5, 2.0, hw[0] * hw[1])).reshape(hw).astype(np.float32)
    depth[rs.rand(*hw) < 0.1] = 0.0  # sensor holes
    return rgb, depth


def _close(ours, ref, rtol=DEPTH_RTOL):
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (H, W)
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0)


@pytest.fixture(autouse=True)
def _outputs_in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # D3RoMa makes _outputs.<variant>/ in the working directory


def test_rgb_raw_single_and_batch_match_jax(tree):
    ref, ours = _pair(tree, "rgb+raw", [], calls=2)
    rgb, raw = _frame(0)
    _close(ours.infer_with_rgb_raw(rgb, raw), ref.infer_with_rgb_raw(rgb, raw))
    frames = [_frame(1), _frame(2, 2.0)]
    for a, b in zip(ours.infer_with_rgb_raw_batch(frames), ref.infer_with_rgb_raw_batch(frames)):
        _close(a, b)
    # random weights: a spread of depths, not a constant map
    assert np.ptp(b) > 0


def test_left_right_raw_infer_matches_jax(tree):
    ref, ours = _pair(tree, "left+right+raw", [], calls=1)
    rs = np.random.RandomState(3)
    left = rs.randint(0, 256, FRAME_HW).astype(np.uint8)
    right = rs.randint(0, 256, FRAME_HW).astype(np.uint8)
    rgb, raw = _frame(4)
    _close(ours.infer(left, right, raw_depth=raw, rgb=rgb),
           ref.infer(left, right, raw_depth=raw, rgb=rgb))


def test_two_rounds_and_the_warm_frame_under_ssi(tree):
    """R = 2 on SSI least squares: the depth and last_uncertainty; then the
    server's warm frame (black, a constant 1 m: a constant SSI window),
    which both packages serve with a finite depth."""
    ssi = ["task.num_inference_rounds=2", "task.ssi=true", "task.safe_ssi=false"]
    ref, ours = _pair(tree, "rgb+raw", ssi, calls=2)
    frames = [_frame(5)]
    (a,), (b,) = ours.infer_with_rgb_raw_batch(frames), ref.infer_with_rgb_raw_batch(frames)
    _close(a, b)
    assert ours.last_uncertainty.shape == ref.last_uncertainty.shape == (1, H, W)
    np.testing.assert_allclose(ours.last_uncertainty, ref.last_uncertainty,
                               rtol=DEPTH_RTOL, atol=DEPTH_RTOL * ref.last_uncertainty.max())
    assert ref.last_uncertainty.max() > 0
    warm = [(np.zeros((360, 640, 3), np.uint8), np.ones((360, 640), np.float32))]
    (a,), (b,) = ours.infer_with_rgb_raw_batch(warm), ref.infer_with_rgb_raw_batch(warm)
    _close(a, b)


def test_two_intermediates_under_safe_ssi(tree, monkeypatch, caplog):
    """num_intermediate_images=2 with SSI RANSAC: the port denormalizes
    each frame's images as the JAX post_fn does, with the RANSAC subsets of
    the JAX key (fold_in(call key, 1), then fold_in(., i) an iteration)."""
    extra = ["task.num_intermediate_images=2", "task.ssi=true", "task.safe_ssi=true"]
    ref, ours = _pair(tree, "rgb+raw", extra, calls=1)
    assert ours.config.num_intermediate_images == 2 and ours.normer.safe_ssi
    rkey = jax.random.fold_in(_jax_call_keys(1)[0], 1)
    n = H * W
    subsets = torch.from_numpy(np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(rkey, i), n)[:int(0.1 * n)]) for i in range(10)]))

    def denormalize(config, pred, raw, mask, generator=None):
        return Normalizer.from_config(config).denormalize(pred, raw, mask, subsets=subsets)

    monkeypatch.setattr(port_inference, "denormalize", denormalize)
    caplog.set_level(logging.INFO)
    rgb, raw = _frame(6)
    _close(ours.infer_with_rgb_raw(rgb, raw), ref.infer_with_rgb_raw(rgb, raw))
    logged = {r.name.split(".")[0]: r.args for r in caplog.records
              if r.msg == "metrics vs raw: %s"}
    theirs, mine = logged["d3roma_tpu"], logged["d3roma_tpu_torch"]
    for group in ("disp", "depth"):
        for k, v in theirs[group].items():
            assert mine[group][k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-6), (group, k)


class _Fixed:
    """The port's pipeline on explicit noise: the batch's rows [lo, lo + b)."""

    def __init__(self, pipe, x_init, noise):
        self.pipe, self.x_init, self.noise, self.lo = pipe, x_init, noise, 0

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        sl = slice(self.lo, self.lo + kw["rgb_images"].shape[0])
        return self.pipe(latents=torch.from_numpy(self.x_init[sl]),
                         step_noise=[torch.from_numpy(n[sl]) for n in self.noise], **kw)


def test_batch_equals_each_frame_alone(tree):
    """Three frames at 0.5, 1 and 4 m in one call against each frame alone
    on its rows of the same noise, under SSI least squares: the same depths,
    each at its own scale."""
    droma = D3RoMa(["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tree / 'rgb_raw'}",
                    "task.ssi=true", "task.safe_ssi=false"] + COMMON,
                   Realsense.default_real("fxm"), variant="rgb+raw", device="cpu")
    x_init, noise = jax_noise_schedule(jax.random.PRNGKey(7), (3, H // 2, W // 2, 4), STEPS)
    droma.pipeline = fixed = _Fixed(droma.pipeline, x_init, noise)
    frames = [_frame(10 + i, s) for i, s in enumerate((0.5, 1.0, 4.0))]
    batch = droma.infer_with_rgb_raw_batch(frames)
    for i, (rgb, raw) in enumerate(frames):
        fixed.lo = i
        alone = droma.infer_with_rgb_raw(rgb, raw)
        np.testing.assert_allclose(batch[i], alone, rtol=0,
                                   atol=BATCH_VS_SINGLE_RTOL * np.abs(alone).max())
    medians = [np.median(d[d > 0]) for d in batch]
    assert medians[0] < medians[1] < medians[2]


def test_prep_rgb_raw_is_bit_equal_to_jax():
    ov = ["task=eval_ldm_mixed_rgb+raw", "task.image_size=[360,640]"]
    ref = JaxD3RoMa(ov, JaxRealsense.default_real("fxm"), variant="rgb+raw", pipeline=object())
    ours = D3RoMa(ov, Realsense.default_real("fxm"), variant="rgb+raw", pipeline=object(),
                  device="cpu")
    rs = np.random.RandomState(0)
    for hw, channels in (((480, 848), 3), ((360, 640), 3), ((200, 300), None), ((361, 641), 4)):
        shape = hw if channels is None else hw + (channels,)
        rgb = rs.randint(0, 256, shape).astype(np.uint8)
        raw = rs.uniform(0.2, 5.0, hw).astype(np.float32)
        raw[rs.rand(*hw) < 0.2] = 0.0
        for a, b in zip(ours._prep_rgb_raw(rgb, raw), ref._prep_rgb_raw(rgb, raw)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (hw, channels)


@pytest.mark.parametrize("case", ["variant", "missing_path", "tensor_parallel", "aot_cache"])
def test_refusals(tree, case):
    ov = ["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tree / 'rgb_raw'}"] + COMMON
    variant, err = "rgb+raw", NotImplementedError
    if case == "variant":
        variant, err = "rgb", AssertionError
    elif case == "missing_path":
        ov, err = ov + [f"task.resume_pretrained={tree / 'absent'}"], ValueError
    elif case == "tensor_parallel":  # outside a process group
        ov, err = ov + ["task.tensor_parallel=2"], RuntimeError
    else:
        ov = ov + [f"task.aot_cache={tree / 'aot'}"]
    with pytest.raises(err):
        D3RoMa(ov, Realsense.default_real("fxm"), variant=variant, device="cpu")


def test_http_server_serves_the_port(tree):
    droma = D3RoMa(["task=eval_ldm_mixed_rgb+raw", f"task.resume_pretrained={tree / 'rgb_raw'}",
                    "task.ssi=true", "task.safe_ssi=false"] + COMMON,
                   Realsense.default_real("fxm"), variant="rgb+raw", device="cpu")
    server = InferenceHTTPServer(droma.infer_with_rgb_raw_batch, max_batch=4, max_wait_ms=200,
                                 warmup_input=(np.zeros((360, 640, 3), np.uint8),
                                               np.ones((360, 640), np.float32)))
    port = server.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                    health = json.loads(r.read())
                break
            except urllib.error.HTTPError:  # 503 while warming
                time.sleep(0.05)
        assert health["status"] == "ok" and "warmup_error" not in health
        scales = (0.5, 1.0, 1.5)
        results = {}

        def call(i):
            rgb, raw = _frame(20 + i, scales[i])
            buf = io.BytesIO()
            np.savez_compressed(buf, rgb=rgb, raw_depth=raw)
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/infer_rgb_raw",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = np.load(io.BytesIO(r.read()))["depth"]

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, s in enumerate(scales):
            d = results[i]
            assert d.shape == (H, W) and d.dtype == np.float32 and np.isfinite(d).all()
            med = np.median(d[d > 0])
            assert min(scales, key=lambda c: abs(np.log(med / c))) == s, (i, med)
        m = server.metrics
        assert m["errors"] == 0 and m["frames_served"] == 3
    finally:
        server.stop()


def test_demo_matches_the_jax_demo(tree, tmp_path, monkeypatch):
    import importlib.util
    import os

    from d3roma_tpu_torch import demo, inference
    from d3roma_tpu_torch.utils.png import read_png
    from d3roma_tpu_torch.utils.pointcloud import read_ply

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("jax_demo", os.path.join(repo, "inference.py"))
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    argv = ["--variant", "rgb+raw", "--assets", os.path.join(repo, "assets", "examples"),
            "--pretrained", str(tree / "rgb_raw")] + COMMON
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_demo.main(argv)
    preds = []
    infer = inference.D3RoMa.infer_with_rgb_raw
    monkeypatch.setattr(inference.D3RoMa, "infer_with_rgb_raw",
                        lambda self, *a: preds.append(infer(self, *a)) or preds[-1])
    monkeypatch.chdir(tmp_path / "port")
    assert demo.main(argv + ["--device", "cpu"]) == 0
    j, p = tmp_path / "jax" / "_outputs.rgb+raw", tmp_path / "port" / "_outputs.rgb+raw"
    assert (p / "raw.ply").read_bytes() == (j / "raw.ply").read_bytes()
    assert np.array_equal(read_png(str(p / "raw_aligned.png")),
                          read_png(str(j / "raw_aligned.png")))
    pts, cols = read_ply(str(p / "pred.ply"))
    (pred,) = preds
    assert len(pts) == int((pred > 0).sum()) > 0 and cols.shape == (len(pts), 3)
    assert read_png(str(p / "pred.png")).shape == (H, W, 3)
