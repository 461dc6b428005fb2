"""Reference checkpoints without JAX: the port's safetensors / .bin reader
and `python -m d3roma_tpu_torch.import_reference` against the JAX
package's `scripts/import_reference_pipeline.py` on the same synthetic
diffusers directories (the writers of tests/test_import_e2e.py).

- the reader equals `safetensors.numpy.load_file` for F32 and F16 (and the
  torch reader for BF16, which numpy cannot hold), `.bin` files read as
  torch.load reads them;
- both importers on one directory write the same pipeline: every
  parameter leaf bit-equal (dtype included), `text_embed` within
  TEXT_EMBED_ATOL, the same sampler, guidance and normalizer; the JAX
  `from_pretrained` reads the port's directory. Cases: the e2e writers'
  bare SD-style directory (list head counts, .bin, a text tower, a guidance
  config, conv_in widened for rgb+raw); the same as fp16 safetensors with a
  scalar head count, 1x1-conv proj_in / proj_out and no text_encoder/; the
  pixel family (a UNet2DModel);
- the head-dim rule on SD2.1's and SD1.x's configs, and `widen_conv_in`
  bit-equal to the JAX one in fp32.
"""

import json
import os

import numpy as np
import pytest
import torch

from d3roma_tpu_torch.import_reference import head_dim_of
from d3roma_tpu_torch.import_reference import main as port_import
from d3roma_tpu_torch.models.torch_import import load_torch_state_dict, widen_conv_in
from d3roma_tpu_torch.utils import flax_msgpack
from d3roma_tpu_torch.utils.safetensors import load_file
from test_import_e2e import _conv, _resnet, _vae_attn, _write_cond_unet, _write_text_encoder, \
    _write_vae

# fp32 on both sides, the sums of a 1-layer tower in another order
TEXT_EMBED_ATOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int32])
def test_safetensors_reader(tmp_path, dtype):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors.torch import save_file

    rs = np.random.RandomState(0)
    tensors = {"a.weight": torch.from_numpy(rs.standard_normal((5, 3, 3, 3))).to(dtype),
               "b": torch.from_numpy(rs.standard_normal((7,))).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype)}
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = load_file(path)
    ref = (torch_load(path) if dtype == torch.bfloat16
           else {k: torch.from_numpy(v) for k, v in np_load(path).items()})
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k], ref[k]), k
    # a model directory finds it; a .bin next to it is read only without it
    torch.save({"c": torch.ones(2)}, str(tmp_path / "diffusion_pytorch_model.bin"))
    assert set(load_torch_state_dict(str(tmp_path))) == set(tensors)
    os.remove(path)
    assert torch.equal(load_torch_state_dict(str(tmp_path))["c"], torch.ones(2))


def _write_scheduler(ref):
    os.makedirs(os.path.join(ref, "scheduler"), exist_ok=True)
    with open(os.path.join(ref, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "MyDDIMScheduler", "num_train_timesteps": 16,
                   "beta_schedule": "scaled_linear", "beta_start": 0.00085,
                   "beta_end": 0.012, "prediction_type": "v_prediction",
                   "clip_sample": False, "steps_offset": 1}, f)


def _to_fp16_safetensors(model_dir, edit=None):
    """Rewrite a directory's .bin as fp16 safetensors, `edit` applied to the
    state dict first."""
    from safetensors.torch import save_file

    path = os.path.join(model_dir, "diffusion_pytorch_model.bin")
    sd = torch.load(path, weights_only=True)
    if edit:
        sd = edit(sd)
    save_file({k: v.half().contiguous() for k, v in sd.items()},
              os.path.join(model_dir, "diffusion_pytorch_model.safetensors"))
    os.remove(path)


def _proj_as_conv(sd):
    return {k: v[:, :, None, None] if ".proj_" in k and k.endswith("weight") else v
            for k, v in sd.items()}


def _write_pixel_unet(dirpath):
    """A tiny diffusers UNet2DModel: blocks (8, 16), (Down, AttnDown) /
    (AttnUp, Up), one layer a block, rgb+raw in, one channel out."""
    os.makedirs(dirpath, exist_ok=True)
    cfg = {"_class_name": "UNet2DModel", "in_channels": 5, "out_channels": 1,
           "block_out_channels": [8, 16], "layers_per_block": 1,
           "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
           "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "norm_num_groups": 4}
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(cfg, f)
    sd, temb = {}, 32
    _conv(sd, "conv_in", 8, 5)
    for name, o, i in (("linear_1", temb, 8), ("linear_2", temb, temb)):
        sd[f"time_embedding.{name}.weight"] = torch.randn(o, i) * 0.05
        sd[f"time_embedding.{name}.bias"] = torch.randn(o) * 0.05
    _resnet(sd, "down_blocks.0.resnets.0", 8, 8, temb)
    _conv(sd, "down_blocks.0.downsamplers.0.conv", 8, 8)
    _resnet(sd, "down_blocks.1.resnets.0", 8, 16, temb)
    _vae_attn(sd, "down_blocks.1.attentions.0", 16)
    _resnet(sd, "mid_block.resnets.0", 16, 16, temb)
    _vae_attn(sd, "mid_block.attentions.0", 16)
    _resnet(sd, "mid_block.resnets.1", 16, 16, temb)
    # up 0 (AttnUp): skips d1r0 16, d0down 8; up 1 (Up): skips d0r0 8, conv_in 8
    _resnet(sd, "up_blocks.0.resnets.0", 32, 16, temb)
    _vae_attn(sd, "up_blocks.0.attentions.0", 16)
    _resnet(sd, "up_blocks.0.resnets.1", 24, 16, temb)
    _vae_attn(sd, "up_blocks.0.attentions.1", 16)
    _conv(sd, "up_blocks.0.upsamplers.0.conv", 16, 16)
    _resnet(sd, "up_blocks.1.resnets.0", 24, 8, temb)
    _resnet(sd, "up_blocks.1.resnets.1", 16, 8, temb)
    for n in ("norm",):
        sd[f"conv_{n}_out.weight"] = torch.ones(8)
        sd[f"conv_{n}_out.bias"] = torch.zeros(8)
    _conv(sd, "conv_out", 1, 8)
    sd["class_embedding.weight"] = torch.ones(3, 32)  # unused by the reference: dropped
    torch.save(sd, os.path.join(dirpath, "diffusion_pytorch_model.bin"))


def _reference_dir(root, case):
    ref = str(root / "ref")
    _write_scheduler(ref)
    if case == "pixel":
        _write_pixel_unet(os.path.join(ref, "unet"))
        return ref
    _write_cond_unet(os.path.join(ref, "unet"))
    _write_vae(os.path.join(ref, "vae"))
    if case == "sd":
        _write_text_encoder(os.path.join(ref, "text_encoder"))
        os.makedirs(os.path.join(ref, "guidance"))
        with open(os.path.join(ref, "guidance", "config.json"), "w") as f:
            json.dump({"flow_guidance_weight": 1.0, "flow_guidance_mode": "gradient",
                       "perturb_start_ratio": 0.5, "unused": 3}, f)
        return ref
    # fp16 safetensors, a scalar head count (8 / 1 = 8 wide), 1x1-conv
    # projections, no text tower
    unet_cfg = os.path.join(ref, "unet", "config.json")
    with open(unet_cfg) as f:
        cfg = json.load(f)
    cfg["attention_head_dim"] = 1
    with open(unet_cfg, "w") as f:
        json.dump(cfg, f)
    _to_fp16_safetensors(os.path.join(ref, "unet"), _proj_as_conv)
    _to_fp16_safetensors(os.path.join(ref, "vae"))
    return ref


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _same_params(a_dir, b_dir):
    a, b = (dict(_leaves(flax_msgpack.load(os.path.join(d, "params.msgpack"))))
            for d in (a_dir, b_dir))
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in a:
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype)
        assert torch.equal(x, y), k
    return a


@pytest.mark.parametrize("case", ["sd", "fp16_safetensors", "pixel"])
def test_import_matches_jax(tmp_path, case):
    from d3roma_tpu.pipelines import GuidedDiffusionPipeline as JaxPixel
    from d3roma_tpu.pipelines import GuidedLatentDiffusionPipeline as JaxLatent
    from scripts.import_reference_pipeline import main as jax_import

    ref = _reference_dir(tmp_path, case)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_import([ref, jax_out, "--cond-channels", "rgb+raw"])
    assert port_import([ref, port_out, "--cond-channels", "rgb+raw", "--device", "cpu"]) == 0

    with open(os.path.join(jax_out, "model_index.json")) as f:
        jax_meta = json.load(f)
    with open(os.path.join(port_out, "model_index.json")) as f:
        port_meta = json.load(f)
    assert port_meta == jax_meta
    for model in ("unet",) if case == "pixel" else ("unet", "vae"):
        params = _same_params(os.path.join(jax_out, model), os.path.join(port_out, model))
        with open(os.path.join(jax_out, model, "config.json")) as f:
            jax_cfg = json.load(f)
        with open(os.path.join(port_out, model, "config.json")) as f:
            assert json.load(f) == jax_cfg
        if model == "unet":
            want = torch.float16 if case == "fp16_safetensors" else torch.float32
            assert {v.dtype for v in params.values()} == {want}
    if case == "pixel":
        assert port_meta["normalizer"]["ssi"]
        JaxPixel.from_pretrained(port_out)
        return

    assert jax_meta["scheduler"]["kind"] == "my_ddim"
    assert not port_meta["normalizer"]["ssi"] and port_meta["normalizer"]["ch_bounds"] == [128.0]
    if case == "sd":
        assert port_meta["guidance"]["flow_guidance_mode"] == "gradient"
        assert port_meta["guidance"]["perturb_start_ratio"] == 0.5
    ours = np.load(os.path.join(port_out, "text_embed.npy"))
    theirs = np.load(os.path.join(jax_out, "text_embed.npy"))
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape == (1, 2, 16)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TEXT_EMBED_ATOL)
    assert (np.abs(ours).max() > 0) == (case == "sd")
    # the JAX package reads the port's directory: the same parameters
    pipe = JaxLatent.from_pretrained(port_out)
    kernel = pipe.unet_params["conv_in"]["kernel"]
    assert kernel.shape[2] == 12 and pipe.unet.attention_head_dim == 8
    np.testing.assert_array_equal(
        np.asarray(kernel), np.asarray(JaxLatent.from_pretrained(jax_out).unet_params[
            "conv_in"]["kernel"]))


def test_head_dim_rule_and_conv_in_widening():
    sd21 = {"block_out_channels": [320, 640, 1280, 1280], "attention_head_dim": [5, 10, 20, 20]}
    assert head_dim_of(sd21) == 64
    assert head_dim_of(dict(sd21, attention_head_dim=8)) == 40  # SD1.x: a head count
    assert head_dim_of(dict(sd21, attention_head_dim=64)) == 64  # a head width
    assert head_dim_of(dict(sd21, attention_head_dim=3)) == 3  # does not divide 320

    from d3roma_tpu.models.torch_import import widen_conv_in as jax_widen

    rs = np.random.RandomState(1)
    w = rs.standard_normal((8, 4, 3, 3)).astype(np.float32)
    b = rs.standard_normal((8,)).astype(np.float32)
    ours = widen_conv_in({"conv_in.weight": torch.from_numpy(w),
                          "conv_in.bias": torch.from_numpy(b)}, 3)
    theirs = jax_widen({"conv_in": {"kernel": w.transpose(2, 3, 1, 0), "bias": b}}, 3)
    np.testing.assert_array_equal(ours["conv_in.weight"].numpy(),
                                  np.asarray(theirs["conv_in"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ours["conv_in.bias"].numpy(),
                                  np.asarray(theirs["conv_in"]["bias"]))
