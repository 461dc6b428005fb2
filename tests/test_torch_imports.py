"""The port stands alone: it imports with jax, flax, optax, orbax, msgpack,
d3roma_tpu, safetensors, transformers and diffusers made unimportable, its
entry points run on the CPU when asked to, and without a GPU they raise
instead of falling back; the evaluation and training entry points also run
with OpenCV, PIL, PyYAML, matplotlib (and for training tensorboardX)
unimportable, the reference-checkpoint entry points (import_reference,
parity_check) with the hub packages unimportable, and the offline tools
(stereo_matching, check_sceneflow, calibrate_pipeline, the native EXR
reader, reprojection, profiling) and the mono datasets (the port's JPEG
decoder and HDF5 reader) with OpenCV, PIL and h5py unimportable; the
synthetic-data workflow (the Isaac replicator package, render_synthetic,
camera_test, the line charts) with those, PyYAML, matplotlib and Isaac Sim
unimportable."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_CHILD = r'''
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
                                  "d3roma_tpu", "safetensors", "transformers", "diffusers"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import torch
import d3roma_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3roma_tpu_torch.__path__,
                                                "d3roma_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "flax", "optax", "orbax", "msgpack", "d3roma_tpu",
                                  "safetensors", "transformers", "diffusers")
               for m in sys.modules)

from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec

unet_kw = dict(in_channels=12, block_out_channels=(32, 64),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               attention_head_dim=32, cross_attention_dim=16, norm_groups=8)
vae_kw = dict(block_out_channels=(32, 64), norm_groups=8)
spec = SamplerSpec("my_ddim", ScheduleConfig(prediction_type="v_prediction",
                                             clip_sample=False))
norm = Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                  ch_gammas=(1.0,))

pipe = GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**unet_kw, device="cpu"),
    vae=AutoencoderKL(**vae_kw, device="cpu"), text_embed=torch.zeros(1, 2, 16),
    spec=spec, normalizer=norm, device="cpu").fast_inference("latency")
out = pipe(num_inference_steps=1, num_intermediate_images=1, cond_channels="rgb+raw",
           rgb_images=torch.zeros(1, 32, 64, 3), sim_disp=torch.zeros(1, 32, 64, 1),
           generator=torch.Generator().manual_seed(0))
assert tuple(out.images.shape) == (1, 32, 64, 1) and torch.isfinite(out.images).all()

# the bench default (static int8, DeepCache, calibration) on the CPU as well
bench = GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**unet_kw, device="cpu"), vae=AutoencoderKL(**vae_kw, device="cpu"),
    text_embed=torch.zeros(1, 2, 16), spec=spec, normalizer=norm, device="cpu")
batch = dict(rgb_images=torch.rand(1, 32, 64, 3), sim_disp=torch.rand(1, 32, 64, 1))
bench.fast_inference("throughput").deepcache(2).calibrate(
    torch.Generator().manual_seed(0), [batch], num_inference_steps=2)
assert set(bench.act_scales) == {"unet", "unet_cached", "vae_encode", "vae_decode"}
out = bench(num_inference_steps=2, num_intermediate_images=1, cond_channels="rgb+raw",
            generator=torch.Generator().manual_seed(1), **batch)
assert tuple(out.images.shape) == (1, 32, 64, 1) and torch.isfinite(out.images).all()

# the opt-in configuration (Winograd, fused GroupNorm, fused int8 attention)
from d3roma_tpu_torch.ops.kernels import (
    conv3x3_winograd, fused_self_attention_int8, group_norm_silu)
opt = GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**dict(unet_kw, block_out_channels=(64, 128), attention_head_dim=64),
                         device="cpu"),
    vae=AutoencoderKL(**vae_kw, device="cpu"), text_embed=torch.zeros(1, 2, 16), spec=spec,
    normalizer=norm, device="cpu").fast_inference("wino").fuse_norms()
opt.unet.set_kernels(use_flash_attention="fused")
opt.deepcache(2).calibrate(torch.Generator().manual_seed(0), [batch], num_inference_steps=2)
out = opt(num_inference_steps=2, num_intermediate_images=1, cond_channels="rgb+raw",
          generator=torch.Generator().manual_seed(1), **batch)
assert tuple(out.images.shape) == (1, 32, 64, 1) and torch.isfinite(out.images).all()
assert min(f.launches for f in (conv3x3_winograd, fused_self_attention_int8,
                                group_norm_silu)) > 0

# the pixel pipeline, its directory written and read back without msgpack
import tempfile
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import UNet2D
from d3roma_tpu_torch.pipelines import GuidedDiffusionPipeline
pixel_kw = dict(in_channels=5, out_channels=1, block_out_channels=(16, 32),
                down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                norm_groups=8)
pix = GuidedDiffusionPipeline(
    unet=UNet2D(**pixel_kw, device="cpu"),
    spec=SamplerSpec("my_ddpm", ScheduleConfig(num_train_timesteps=128,
                                               prediction_type="sample")),
    guidance=FlowGuidance(flow_guidance_weight=0.0), normalizer=Normalizer(ssi=True),
    device="cpu").quantize_int8()
pix_kw = dict(num_inference_steps=2, num_intermediate_images=1, depth_channels=1,
              cond_channels="rgb+raw", rgb_images=torch.zeros(1, 16, 16, 3),
              sim_disp=torch.zeros(1, 16, 16, 1))
out = pix(generator=torch.Generator().manual_seed(0), **pix_kw)
assert tuple(out.images.shape) == (1, 16, 16, 1) and torch.isfinite(out.images).all()
with tempfile.TemporaryDirectory() as d:
    pix.save_pretrained(d)
    again = GuidedDiffusionPipeline.from_pretrained(d, device="cpu").quantize_int8()
    out2 = again(generator=torch.Generator().manual_seed(0), **pix_kw)
assert torch.equal(out.images, out2.images)

if not torch.cuda.is_available():
    cpu_unet = UNet2DCondition(**unet_kw, device="cpu")
    for make in (lambda: UNet2DCondition(**unet_kw), lambda: AutoencoderKL(**vae_kw),
                 lambda: spec.schedule.tables(),
                 lambda: GuidedLatentDiffusionPipeline(
                     unet=cpu_unet, vae=AutoencoderKL(**vae_kw, device="cpu"),
                     text_embed=torch.zeros(1, 2, 16), spec=spec, normalizer=norm),
                 lambda: UNet2D(**pixel_kw),
                 lambda: GuidedDiffusionPipeline(
                     unet=UNet2D(**pixel_kw, device="cpu"), spec=pix.spec,
                     guidance=pix.guidance, normalizer=pix.normalizer),
                 lambda: GuidedDiffusionPipeline.from_pretrained("unused")):
        try:
            make()
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("an entry point ran without CUDA and without device='cpu'")
print("OK", len(names))
'''


def test_port_imports_without_jax_and_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|orbax|msgpack|d3roma_tpu|safetensors"
                         r"|transformers|diffusers)([ .]|$)")
    files = sorted((REPO / "d3roma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f}:{i}" for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders


_EVAL_CHILD = r"""
import runpy, sys, tempfile, os

BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu", "cv2", "PIL", "yaml", "matplotlib",
           "safetensors", "transformers", "diffusers")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import torch
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset

root = tempfile.mkdtemp()
os.chdir(root)
unet_kw = dict(in_channels=12, block_out_channels=(32, 64),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               attention_head_dim=32, cross_attention_dim=16, norm_groups=8)
GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**unet_kw, device="cpu"),
    vae=AutoencoderKL(block_out_channels=(32, 64), norm_groups=8, device="cpu"),
    text_embed=torch.zeros(1, 2, 16),
    spec=SamplerSpec("my_ddim", ScheduleConfig(prediction_type="v_prediction")),
    normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(8.0,),
                          ch_gammas=(1.0,)), device="cpu").save_pretrained("pipe")
generate_dataset("datasets/HISS", 2, split="test", config=SceneConfig(height=36, width=64))
sys.argv = ["evaluate", "--device", "cpu", "task=eval_ldm_mixed_rgb+raw",
            "task.resume_pretrained=pipe", "task.eval_dataset=[HISS]",
            "task.camera_resolution=48x27", "task.eval_batch_size=2",
            "task.num_inference_timesteps=1", "task.fast_inference=latency",
            "task.eval_output=out"]
try:
    runpy.run_module("d3roma_tpu_torch.evaluate", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
for name in ("idx0_0_pred_disp.png", "idx0_1_pred_disp.png", "idx0_error.png",
             "idx0_denoised.png", "idx0_0_simDepthImage.exr", "idx0_1_simDepthImage.exr"):
    assert os.path.exists(os.path.join("out", "HISS", name)), name
print("EVAL OK")
"""


def test_evaluate_runs_without_jax_opencv_pil_yaml_or_matplotlib():
    """The evaluation entry point end to end (a saved pipeline, procedural
    frames resized by the loader, metrics, every HISS artifact) with jax,
    the JAX package, OpenCV, PIL, PyYAML and matplotlib unimportable, as on
    the machine with the card."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _EVAL_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "EVAL OK" in proc.stdout and '"dataset": "HISS"' in proc.stdout


def test_no_source_line_imports_opencv_pil_yaml_or_matplotlib():
    """None of these (nor h5py) is on the machine with the card."""
    pattern = re.compile(r"^\s*(import|from) (cv2|PIL|yaml|matplotlib|h5py)([ .]|$)")
    files = sorted((REPO / "d3roma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f}:{i}" for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders


_TRAIN_CHILD = r"""
import os, runpy, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "d3roma_tpu", "cv2", "PIL",
           "yaml", "matplotlib", "tensorboardX", "safetensors", "transformers", "diffusers")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import numpy as np
import torch
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from d3roma_tpu_torch.utils import png
from d3roma_tpu_torch.utils.frame_utils import writePFM

root = tempfile.mkdtemp()
os.chdir(root)
generate_dataset("datasets/HISS", 4, split="train", config=SceneConfig(height=36, width=64))
generate_dataset("datasets/HISS", 2, split="val", config=SceneConfig(height=36, width=64))
# SceneFlow frames at twice the camera's resolution: the loader resizes them
rs = np.random.RandomState(0)
sub = "datasets/SceneFlow/FlyingThings3D/{}/TRAIN/A/0000/{}"
for i in range(4):
    for side in ("left", "right"):
        os.makedirs(sub.format("frames_cleanpass", side), exist_ok=True)
        png.write_png(sub.format("frames_cleanpass", side) + f"/{i:04d}.png",
                      rs.randint(0, 256, (72, 128, 3)).astype(np.uint8))
    for kind in ("disparity", "raw_cleanpass"):
        os.makedirs(sub.format(kind, "left"), exist_ok=True)
        writePFM(sub.format(kind, "left") + f"/{i:04d}.pfm",
                 rs.uniform(4, 60, (72, 128)).astype(np.float32))
args = ["task=train_hiss", "task.cond_channels=rgb+raw", "task.train_dataset=[SceneFlow,HISS]",
        "task.dataset_weight=[1,1]", "task.camera_resolution=64x36", "task.image_size=[32,48]",
        "task.divis_by=16", "task.block_out_channels=[8,16]", "task.train_batch_size=2",
        "task.eval_batch_size=2", "task.eval_num_batch=1", "task.num_epochs=1",
        "task.val_every_global_steps=2", "task.save_model_epochs=1",
        "task.num_inference_timesteps=2", "task.output_dir=run"]
from d3roma_tpu_torch.train import main
if not torch.cuda.is_available():
    try:
        main(args)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("training ran without CUDA and without --device cpu")
sys.argv = ["train", "--device", "cpu", "--seed", "2"] + args
try:
    runpy.run_module("d3roma_tpu_torch.train", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
log = open("run/train.log").read()
assert "tensorboardX unavailable" in log
steps = [line for line in log.splitlines() if " loss " in line and " grad_norm " in line]
assert len(steps) == 4, log
for name in ("checkpoints/last/state.pt", "checkpoints/last/counter.json", "best/model_index.json",
             "epoch_0000/unet/params.msgpack"):
    assert os.path.exists(os.path.join("run", name)), name
print("TRAIN OK")
"""


def test_train_runs_without_jax_optax_orbax_opencv_or_tensorboardx():
    """The training entry point end to end on the CPU (SceneFlow frames
    the loader resizes, procedural HISS frames, in-training eval, the
    exports and the checkpoint) with jax, optax, orbax, the JAX package,
    OpenCV, PIL, PyYAML, matplotlib and tensorboardX unimportable; without
    a GPU and without --device it raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _TRAIN_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "TRAIN OK" in proc.stdout


_SERVE_CHILD = r"""
import io, json, os, runpy, signal, socket, sys, tempfile, threading, time, urllib.request

BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu", "cv2", "PIL", "yaml", "matplotlib",
           "pyrealsense2", "rospy", "cv_bridge", "safetensors", "transformers", "diffusers")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import numpy as np
import torch
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.utils.png import read_png
from d3roma_tpu_torch.utils.pointcloud import read_ply

root = tempfile.mkdtemp()
os.chdir(root)
unet_kw = dict(in_channels=12, block_out_channels=(32, 64),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               attention_head_dim=32, cross_attention_dim=16, norm_groups=8)
GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**unet_kw, device="cpu"),
    vae=AutoencoderKL(block_out_channels=(32, 64), norm_groups=8, device="cpu"),
    text_embed=torch.zeros(1, 2, 16),
    spec=SamplerSpec("my_ddim", ScheduleConfig(prediction_type="v_prediction")),
    normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                          ch_gammas=(1.0,)), device="cpu").save_pretrained("pipe")
small = ["task.image_size=[32,64]", "task.num_inference_timesteps=1",
         "task.num_intermediate_images=1"]

if not torch.cuda.is_available():
    from d3roma_tpu_torch import demo, serve
    from d3roma_tpu_torch.inference import D3RoMa
    for call in (lambda: D3RoMa(),
                 lambda: D3RoMa(["task=eval_ldm_mixed_rgb+raw", "task.resume_pretrained=pipe"],
                                variant="rgb+raw"),
                 lambda: demo.main(["--pretrained", "pipe"] + small),
                 lambda: serve.main(["--port", "0", "--", "task=eval_ldm_mixed_rgb+raw",
                                     "task.resume_pretrained=pipe"] + small)):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("ran without CUDA and without a device")

sys.argv = ["demo", "--device", "cpu", "--pretrained", "pipe"] + small
try:
    runpy.run_module("d3roma_tpu_torch.demo", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
out = "_outputs.rgb+raw"
for name in ("raw_aligned.png", "pred.png"):
    assert read_png(os.path.join(out, name)).shape == (32, 64, 3), name
for name in ("raw.ply", "pred.ply"):
    pts, cols = read_ply(os.path.join(out, name))
    assert len(pts) > 0 and np.isfinite(pts).all() and cols.shape == (len(pts), 3), name

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
result = {}

def client():
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    result["healthz"] = json.loads(r.read())
                    break
            except Exception:
                time.sleep(0.2)
        buf = io.BytesIO()
        np.savez_compressed(buf, rgb=np.zeros((48, 80, 3), np.uint8),
                            raw_depth=np.full((48, 80), 1.5, np.float32))
        req = urllib.request.Request(url + "/v1/infer_rgb_raw", buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            result["depth"] = np.load(io.BytesIO(r.read()))["depth"]
        with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
            result["metrics"] = json.loads(r.read())
    finally:
        os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=client, daemon=True).start()
sys.argv = ["serve", "--host", "127.0.0.1", "--port", str(port), "--max-batch", "2",
            "--device", "cpu", "--", "task=eval_ldm_mixed_rgb+raw",
            "task.resume_pretrained=pipe"] + small
try:
    runpy.run_module("d3roma_tpu_torch.serve", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert result["healthz"]["status"] == "ok" and "warmup_error" not in result["healthz"], result
assert result["depth"].shape == (32, 64) and np.isfinite(result["depth"]).all()
assert result["metrics"]["errors"] == 0 and result["metrics"]["frames_served"] == 1
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("SERVE OK")
"""


def test_demo_and_serve_run_without_jax_opencv_or_hardware_packages():
    """`python -m d3roma_tpu_torch.demo` and `python -m d3roma_tpu_torch.serve`
    (a warm-up, one request, /metrics, then SIGTERM: exit 0) on the CPU with
    jax, the JAX package, OpenCV, PIL, PyYAML, matplotlib, pyrealsense2 and
    ROS unimportable; without a GPU, `D3RoMa()`, the demo and the server
    raise unless given a device."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SERVE OK" in proc.stdout and "server stopped" in proc.stdout


_IMPORT_CHILD = r"""
import runpy, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "d3roma_tpu", "safetensors",
           "transformers", "diffusers", "cv2", "PIL", "yaml", "matplotlib")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import torch

ref, out, gold = sys.argv[1:4]

def run(module, *argv):
    sys.argv = [module] + list(argv)
    try:
        runpy.run_module(module, run_name="__main__")
    except SystemExit as e:
        return e.code
    return 0

assert run("d3roma_tpu_torch.import_reference", ref, out, "--cond-channels", "rgb+raw",
           "--device", "cpu") == 0
for flag in ("--golden-dump", "--golden-compare"):
    assert run("d3roma_tpu_torch.parity_check", "--pipeline-dir", out, flag, gold,
               "--golden-size", "32x64", "--device", "cpu") == 0
assert run("d3roma_tpu_torch.parity_check", "--ref-dir", ref + "/absent") == 0
if not torch.cuda.is_available():
    try:
        run("d3roma_tpu_torch.import_reference", ref, out + "2")
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("import_reference ran without CUDA and without --device cpu")
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("IMPORT OK")
"""


def test_reference_import_runs_without_jax_or_the_hub_packages(tmp_path):
    """`python -m d3roma_tpu_torch.import_reference` on a synthetic diffusers
    directory (a safetensors text tower, .bin UNet and VAE) and
    `python -m d3roma_tpu_torch.parity_check`'s golden dump and compare on
    its output, with jax, the JAX package, safetensors, transformers and
    diffusers unimportable; parity_check without a reference directory
    skips with exit 0; without a GPU and without --device the importer
    raises."""
    import json

    import torch
    from safetensors.torch import save_file

    from test_import_e2e import _write_cond_unet, _write_text_encoder, _write_vae

    ref = tmp_path / "ref"
    _write_cond_unet(str(ref / "unet"))
    _write_vae(str(ref / "vae"))
    _write_text_encoder(str(ref / "text_encoder"))
    te = ref / "text_encoder" / "pytorch_model.bin"
    save_file(torch.load(te, weights_only=True), str(ref / "text_encoder" / "model.safetensors"))
    te.unlink()
    (ref / "scheduler").mkdir()
    (ref / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "MyDDIMScheduler", "prediction_type": "v_prediction"}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHILD, str(ref), str(tmp_path / "out"),
                           str(tmp_path / "golden")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "IMPORT OK" in proc.stdout and "GOLDEN COMPARE: all stages match" in proc.stdout
    assert "PARITY SKIP" in proc.stdout


_DIST_EVAL_CHILD = r"""
import json, os, runpy, socket, subprocess, sys, tempfile

BLOCKER = '''
import sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu", "cv2", "PIL", "yaml",
           "matplotlib", "safetensors", "transformers", "diffusers")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())
'''
exec(BLOCKER)

import torch
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset

root = tempfile.mkdtemp()
os.chdir(root)
unet_kw = dict(in_channels=12, block_out_channels=(32, 64),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
               attention_head_dim=32, cross_attention_dim=16, norm_groups=8)
GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(**unet_kw, device="cpu"),
    vae=AutoencoderKL(block_out_channels=(32, 64), norm_groups=8, device="cpu"),
    text_embed=torch.zeros(1, 2, 16),
    spec=SamplerSpec("my_ddim", ScheduleConfig(prediction_type="v_prediction")),
    normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(8.0,),
                          ch_gammas=(1.0,)), device="cpu").save_pretrained("pipe")
generate_dataset("datasets/HISS", 4, split="test", config=SceneConfig(height=36, width=64))
args = ["--device", "cpu", "task=eval_ldm_mixed_rgb+raw", "task.resume_pretrained=pipe",
        "task.eval_dataset=[HISS]", "task.camera_resolution=48x27", "task.eval_batch_size=2",
        "task.num_inference_timesteps=2", "task.eval_output=out"]

def metrics_line(out):
    return json.loads(next(l for l in out.splitlines() if l.startswith('{"dataset"')))

# one process, then two ranks as torchrun starts them (its environment)
one = subprocess.run([sys.executable, "-c", BLOCKER + "import runpy, sys; sys.argv = "
                      + repr(["evaluate"] + args) + "; runpy.run_module("
                      "'d3roma_tpu_torch.evaluate', run_name='__main__')"],
                     capture_output=True, text=True, timeout=240)
assert one.returncode == 0, one.stderr[-3000:]
code = (BLOCKER + "import runpy, sys; sys.argv = " + repr(["distributed_evaluate"] + args)
        + " + ARGS; runpy.run_module('d3roma_tpu_torch.distributed_evaluate', "
        "run_name='__main__'); assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)")


def two_ranks(extra):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ranks = [subprocess.Popen([sys.executable, "-c", code.replace("ARGS", repr(extra))],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, MASTER_ADDR="localhost",
                                       MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2"))
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in ranks]
    for p, (o, e) in zip(ranks, outs):
        assert p.returncode == 0, e[-3000:]
    assert not any(l.startswith('{"dataset"') for l in outs[1][0].splitlines())  # rank 0 prints
    return metrics_line(outs[0][0])

ref = metrics_line(one.stdout)
# data parallel (each rank 2 of the 4 frames' rows a batch), then tensor
# parallel (each rank every row, half of each sharded weight)
for extra, mesh in (([], {"data": 2}), (["task.tensor_parallel=2"], {"data": 1, "model": 2})):
    got = two_ranks(extra)
    assert got["ranks"] == 2 and got["mesh"] == mesh, got
    for group, sub in ref["metrics"].items():
        for k, v in sub.items():
            assert abs(got["metrics"][group][k] - v) <= 1e-4 * max(abs(v), 1e-3), (
                extra, group, k, v, got["metrics"])
print("DIST EVAL OK")
"""


def test_distributed_evaluate_runs_without_jax_in_two_ranks():
    """`python -m d3roma_tpu_torch.distributed_evaluate` as torchrun starts
    it (two ranks, MASTER_ADDR/PORT, WORLD_SIZE, RANK, LOCAL_RANK; gloo on
    the CPU) with jax, the JAX package, OpenCV, PIL, PyYAML and matplotlib
    unimportable, over 4 procedural HISS frames at batch 2 (fp32): data
    parallel (each rank draws its rows of the whole batch's noise), then
    with task.tensor_parallel=2; each run's metrics within 1e-4 (relative)
    of the one-process `python -m d3roma_tpu_torch.evaluate` on the same
    frames and seed."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DIST_EVAL_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DIST EVAL OK" in proc.stdout


_OFFLINE_CHILD = r"""
import glob, os, shutil, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu", "cv2", "PIL", "h5py", "yaml",
           "matplotlib", "safetensors", "transformers", "diffusers")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import json
import numpy as np
import torch
from d3roma_tpu_torch import calibrate_pipeline, check_sceneflow, stereo_matching
from d3roma_tpu_torch.models import AutoencoderKL, UNet2DCondition
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.reproject import reproject_depth
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import GuidedLatentDiffusionPipeline, SamplerSpec
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from d3roma_tpu_torch.utils import exr, native_io, profiling
from d3roma_tpu_torch.utils.camera import Realsense

root = tempfile.mkdtemp()
os.chdir(root)
generate_dataset("HISS", 2, split="train", config=SceneConfig(height=36, width=64))
GuidedLatentDiffusionPipeline(
    unet=UNet2DCondition(in_channels=12, block_out_channels=(32, 64),
                         down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                         up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                         attention_head_dim=32, cross_attention_dim=16, norm_groups=8,
                         device="cpu"),
    vae=AutoencoderKL(block_out_channels=(32, 64), norm_groups=8, device="cpu"),
    text_embed=torch.zeros(1, 2, 16),
    spec=SamplerSpec("my_ddim", ScheduleConfig(prediction_type="v_prediction")),
    normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(64.0,),
                          ch_gammas=(1.0,)), device="cpu").save_pretrained("pipe")
if not torch.cuda.is_available():
    for call in (lambda: stereo_matching.main(["HISS"]),
                 lambda: calibrate_pipeline.main(["pipe"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("ran without CUDA and without --device")
with profiling.trace("trace"):
    assert stereo_matching.main(["HISS", "--device", "cpu", "--overwrite", "--min-disp", "2",
                                 "--max-disp", "12"]) == 0
assert len(glob.glob("trace/*.json")) == 1
for path in sorted(glob.glob("HISS/**/*_simDepthImage.exr", recursive=True)):
    depth = exr.read_exr(path)
    assert depth.shape == (36, 64) and np.isfinite(depth).all() and (depth > 0).any()
    if shutil.which("g++"):
        assert np.array_equal(native_io.read_exr(path), depth)
assert check_sceneflow.main(["--root", "SceneFlow", "--out", "bad.txt"]) == 0
assert calibrate_pipeline.main(["pipe", "--device", "cpu", "--frames", "1", "--batches", "1",
                                "--image-size", "32x64", "--steps", "2"]) == 0
scales = json.load(open("pipe/act_scales.json"))
calibrated = GuidedLatentDiffusionPipeline.from_pretrained("pipe", device="cpu")
assert calibrated.act_scales == scales
# the serving mode replays the tables the entry point wrote
out = calibrated.fast_inference("throughput")(
    num_inference_steps=2, num_intermediate_images=1, cond_channels="rgb+raw",
    rgb_images=torch.rand(1, 32, 64, 3) * 2 - 1, sim_disp=torch.rand(1, 32, 64, 1),
    generator=torch.Generator().manual_seed(0))
assert tuple(out.images.shape) == (1, 32, 64, 1) and torch.isfinite(out.images).all()
cam = Realsense.default_real("fxm")
cam.change_resolution("64x36")
d = torch.rand(36, 64) + 0.5
out = reproject_depth(d, torch.from_numpy(cam.K_depth.arr), torch.from_numpy(cam.K_color.arr),
                      torch.from_numpy(np.asarray(cam.T_cl)), (36, 64))
assert out.shape == (36, 64) and (out > 0).float().mean() > 0.5
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("OFFLINE OK")
"""


def test_offline_tools_run_without_jax_opencv_pil_or_h5py():
    """The offline entry points on the CPU (the stereo CLI under
    utils/profiling.trace, its EXRs read back through both readers,
    check_sceneflow, calibrate_pipeline and the act_scales.json it writes
    loaded back and replayed under fast_inference("throughput"),
    reprojection) with jax, the JAX package, OpenCV, PIL and
    h5py unimportable; without a GPU and without --device they raise."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _OFFLINE_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OFFLINE OK" in proc.stdout


_MONO_CHILD = r"""
import os, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "d3roma_tpu", "cv2", "PIL", "h5py", "yaml", "matplotlib")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import numpy as np
from d3roma_tpu_torch.config import load_task_preset
from d3roma_tpu_torch.data import create_dataset
from d3roma_tpu_torch.utils import png

fixtures = os.path.abspath(os.path.join("tests", "data", "torch_mono"))
root = tempfile.mkdtemp()
os.chdir(root)

def link(src, dst):
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.symlink(os.path.join(fixtures, src), dst)

link("nyu_depth_v2/official_splits/train/bedroom_0001/00000.h5",
     "datasets/nyu_depth_v2/official_splits/train/bedroom_0001/00000.h5")
for ext in (".tonemap.jpg", ".depth_meters.hdf5"):
    link("hypersim/ai_001_001/frame.0000" + ext, "datasets/hypersim/train/ai_001_001/frame.0000" + ext)
link("jpeg/baseline_420_480x640.jpg", "datasets/ScanNet/train/scene0000_00/color/0.jpg")
os.makedirs("datasets/ScanNet/train/scene0000_00/depth")
png.write_png("datasets/ScanNet/train/scene0000_00/depth/0.png",
              np.full((480, 640), 2500, np.uint16))
cfg = load_task_preset("train_ldm_mono")
for name in ("NYUv2", "HyperSim", "ScanNet"):
    item = create_dataset(cfg, name, "train")[0]
    assert item["rgb"].shape == (180, 320, 3) and item["depth"].shape == (180, 320, 1), name
    valid = item["valid"][..., 0] > 0
    assert valid.mean() > 0.9 and np.isfinite(item["disp"]).all(), name
    assert 0.4 < item["depth"][..., 0][valid].min() <= item["depth"][..., 0][valid].max() < 8.1, name
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("MONO OK")
"""


def test_mono_datasets_load_without_jax_opencv_pil_or_h5py():
    """NYUv2 (HDF5), HyperSim (JPEG + HDF5) and ScanNet (JPEG + 16-bit PNG)
    items through `create_dataset` from the committed fixtures, with jax,
    the JAX package, OpenCV, PIL and h5py unimportable: the port's own JPEG
    decoder and HDF5 reader."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _MONO_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MONO OK" in proc.stdout


_SYNTHETIC_CHILD = r"""
import importlib, os, pkgutil, runpy, sys, tempfile

BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu", "cv2", "PIL", "h5py", "yaml",
           "matplotlib", "isaacsim", "omni", "pxr")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import numpy as np
import d3roma_tpu_torch.synthetic.isaac as isaac
from d3roma_tpu_torch import camera_test, render_synthetic
from d3roma_tpu_torch.utils import png, viz

modules = [m.name for m in pkgutil.walk_packages(isaac.__path__, "d3roma_tpu_torch.synthetic.isaac.")]
for name in modules:
    importlib.import_module(name)
assert len(modules) == 7, modules
examples = os.path.abspath(os.path.join("assets", "examples"))
root = tempfile.mkdtemp()
os.chdir(root)
sys.argv = ["render_synthetic", "--backend", "sim", "depth_sensor.resolution=[64, 36]",
            "num_frames_per_surface=2", "max_surfaces=1", "seed=3",
            "writer_config.output_dir=hiss/train/scene"]
try:
    runpy.run_module("d3roma_tpu_torch.render_synthetic", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert not e.code, e.code
assert sorted(os.listdir("hiss/train/scene"))[:5] == [
    "0000_color.png", "0000_depth.exr", "0000_ir_l.png", "0000_ir_r.png", "0001_color.png"]
assert png.read_png("hiss/train/scene/0001_color.png").shape == (36, 64, 3)
try:
    render_synthetic.build_replicator({}, backend="auto")  # no Isaac Sim: the SimBackend
    render_synthetic.build_replicator({}, backend="omni")
except ImportError as e:
    assert "Isaac Sim" in str(e)
else:
    raise AssertionError("--backend omni ran without Isaac Sim")
assert camera_test.main(["--replay", examples, "--frames", "2"]) == 0
viz.plot_intermediate_metrics({"epe": np.array([2.0, 1.0]), "rel": [0.3, 0.2]}, "m.png")
viz.plot_loss_terms({"loss": [1.0, 0.5, 0.25]}, "l.png")
assert png.read_png("m.png").shape == (240, 640, 3) and png.read_png("l.png").shape == (400, 640, 3)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules), sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("SYNTHETIC OK")
"""


def test_synthetic_workflow_runs_without_jax_opencv_pil_yaml_or_isaac():
    """The replicator package (its seven modules), the render_synthetic
    entry point on the SimBackend (omni refused loudly), camera_test on
    the bundled capture and the two line charts, with jax, the JAX package,
    OpenCV, PIL, h5py, PyYAML, matplotlib and Isaac Sim unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SYNTHETIC_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "SYNTHETIC OK" in proc.stdout and "mean latency:" in proc.stdout
