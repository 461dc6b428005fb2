"""The port stands alone: it imports with jax, flax, msgpack and d3roma_tpu
made unimportable, its entry points run on the CPU when asked to, and
without a GPU they raise instead of falling back."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "d3roma_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import torch
import d3roma_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3roma_tpu_torch.__path__,
                                                "d3roma_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "flax", "msgpack", "d3roma_tpu")
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
    pattern = re.compile(r"^\s*(import|from) (jax|flax|msgpack|d3roma_tpu)([ .]|$)")
    files = sorted((REPO / "d3roma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f}:{i}" for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders
