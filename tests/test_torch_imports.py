"""The port stands alone: it imports with jax, flax and d3roma_tpu made
unimportable, its entry points run on the CPU when asked to, and without a
GPU they raise instead of falling back."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "d3roma_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())

import torch
import d3roma_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3roma_tpu_torch.__path__,
                                                "d3roma_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "flax", "d3roma_tpu") for m in sys.modules)

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

if not torch.cuda.is_available():
    cpu_unet = UNet2DCondition(**unet_kw, device="cpu")
    for make in (lambda: UNet2DCondition(**unet_kw), lambda: AutoencoderKL(**vae_kw),
                 lambda: spec.schedule.tables(),
                 lambda: GuidedLatentDiffusionPipeline(
                     unet=cpu_unet, vae=AutoencoderKL(**vae_kw, device="cpu"),
                     text_embed=torch.zeros(1, 2, 16), spec=spec, normalizer=norm)):
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
    pattern = re.compile(r"^\s*(import|from) (jax|flax|d3roma_tpu)([ .]|$)")
    files = sorted((REPO / "d3roma_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [f"{f}:{i}" for f in files
                 for i, line in enumerate(f.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert not offenders, offenders
