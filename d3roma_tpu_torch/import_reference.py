"""Convert a reference (diffusers) pipeline directory into a pipeline
directory of this project, without JAX.

    python -m d3roma_tpu_torch.import_reference REF_DIR OUT_DIR \
        [--cond-channels rgb+raw] [--device cpu]

The counterpart of `scripts/import_reference_pipeline.py`. REF_DIR is a
diffusers `save_pretrained` directory (unet/ vae/ scheduler/ [text_encoder/
guidance/] subdirectories, torch weights in .safetensors or .bin files) as
the reference train.py exports it; OUT_DIR becomes a
GuidedLatentDiffusionPipeline (or, for a UNet2DModel, a
GuidedDiffusionPipeline) directory in the format both packages'
`from_pretrained` read. The parameters keep the dtypes of the files they
came from, as the JAX importer keeps them. The empty-prompt embedding is
computed once by the CLIP text tower, in fp32 on `--device` (CUDA unless
named; reference: custom_pipelines.py:241-254), so inference needs no
tokenizer; without a text_encoder/ it is zeros of [1, 2,
cross_attention_dim].
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.models import (
    AutoencoderKL,
    UNet2D,
    UNet2DCondition,
    widened_in_channels,
)
from d3roma_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, empty_prompt_tokens
from d3roma_tpu_torch.models.torch_import import (
    clip_text_state_dict,
    load_torch_state_dict,
    unet_state_dict,
    vae_state_dict,
    widen_conv_in,
)
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.pipelines import (
    GuidedDiffusionPipeline,
    GuidedLatentDiffusionPipeline,
    SamplerSpec,
)


def _json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _loaded(model: torch.nn.Module, state_dict) -> torch.nn.Module:
    """`model` (built on the meta device) holding `state_dict`'s tensors
    themselves, in their dtypes; a name missing on either side raises."""
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model


def head_dim_of(ucfg: dict) -> int:
    """The UNet's per-head width from a diffusers config. A list under
    attention_head_dim holds per-block head counts (diffusers' historical
    naming), so the width is block_out_channels[0] // count[0] (SD2.1's [5,
    10, 20, 20] gives 64); a scalar below 32 that divides
    block_out_channels[0] is a head count too (SD1.x's 8 gives 40);
    otherwise the scalar is the width."""
    boc = tuple(ucfg.get("block_out_channels", (320, 640, 1280, 1280)))
    ahd = ucfg.get("attention_head_dim", 64)
    if isinstance(ahd, (list, tuple)):
        return boc[0] // int(ahd[0])
    if int(ahd) < 32 and boc[0] % int(ahd) == 0:
        return boc[0] // int(ahd)
    return int(ahd)


def text_embedding(te_dir: str, device: torch.device) -> torch.Tensor:
    """The empty prompt's [1, 2, hidden] embedding by the CLIP text tower of
    a transformers directory, in fp32 on `device`, returned on the CPU."""
    tcfg = _json(os.path.join(te_dir, "config.json"))
    cfg = CLIPTextConfig(
        vocab_size=tcfg.get("vocab_size", 49408),
        hidden_size=tcfg.get("hidden_size", 1024),
        intermediate_size=tcfg.get("intermediate_size", 4096),
        num_hidden_layers=tcfg.get("num_hidden_layers", 23),
        num_attention_heads=tcfg.get("num_attention_heads", 16),
        max_position_embeddings=tcfg.get("max_position_embeddings", 77),
        hidden_act=tcfg.get("hidden_act", "gelu"),
    )
    clip = _loaded(CLIPTextModel(cfg, device="meta"),
                   clip_text_state_dict(load_torch_state_dict(te_dir)))
    clip = clip.to(device=device, dtype=torch.float32)
    # [BOS, EOS] only: the reference encodes "" with padding="do_not_pad"
    # (train.py:121-129)
    ids = torch.from_numpy(empty_prompt_tokens()).long().to(device)
    with torch.no_grad():
        return clip(ids).cpu()


def import_reference(ref_dir: str, cond_channels: Optional[str] = None,
                     device: DeviceLike = None):
    """The pipeline of a reference directory, its models on the CPU (the
    text tower runs on `device`)."""
    device = resolve_device(device)
    ucfg = _json(os.path.join(ref_dir, "unet", "config.json"))
    is_ldm = (ucfg.get("_class_name", "") == "UNet2DConditionModel"
              or "cross_attention_dim" in ucfg)
    unet_sd = unet_state_dict(load_torch_state_dict(os.path.join(ref_dir, "unet")))

    sch = _json(os.path.join(ref_dir, "scheduler", "scheduler_config.json"))
    schedule = ScheduleConfig(
        num_train_timesteps=sch.get("num_train_timesteps", 1000),
        beta_schedule=sch.get("beta_schedule", "scaled_linear"),
        beta_start=sch.get("beta_start", 0.00085),
        beta_end=sch.get("beta_end", 0.012),
        prediction_type=sch.get("prediction_type", "v_prediction"),
        clip_sample=sch.get("clip_sample", False),
        thresholding=sch.get("thresholding", False),
        timestep_spacing="leading",
        steps_offset=sch.get("steps_offset", 1),
        set_alpha_to_one=False,
    )
    spec = SamplerSpec("my_ddim" if "DDIM" in sch.get("_class_name", "") else "my_ddpm",
                       schedule)
    g = _json(os.path.join(ref_dir, "guidance", "config.json"))
    guidance = FlowGuidance(**{k: g[k] for k in ("flow_guidance_weight", "perturb_start_ratio",
                                                 "flow_guidance_mode") if k in g})

    if not is_ldm:
        unet = _loaded(UNet2D(
            in_channels=ucfg["in_channels"], out_channels=ucfg["out_channels"],
            block_out_channels=tuple(ucfg["block_out_channels"]),
            down_block_types=tuple(ucfg["down_block_types"]),
            up_block_types=tuple(ucfg["up_block_types"]),
            layers_per_block=ucfg.get("layers_per_block", 2), device="meta"), unet_sd)
        return GuidedDiffusionPipeline(unet=unet, spec=spec, guidance=guidance,
                                       normalizer=Normalizer(ssi=True), device="cpu")

    in_ch = ucfg["in_channels"]
    if cond_channels and in_ch == 4:
        unet_sd = widen_conv_in(unet_sd, len(cond_channels.split("+")) + 1)
        in_ch = widened_in_channels(cond_channels)
    boc = tuple(ucfg.get("block_out_channels", (320, 640, 1280, 1280)))
    n = len(boc)
    default_down = ("CrossAttnDownBlock2D",) * (n - 1) + ("DownBlock2D",)
    default_up = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * (n - 1)
    unet = _loaded(UNet2DCondition(
        in_channels=in_ch, out_channels=ucfg.get("out_channels", 4), block_out_channels=boc,
        down_block_types=tuple(ucfg.get("down_block_types", default_down)),
        up_block_types=tuple(ucfg.get("up_block_types", default_up)),
        layers_per_block=ucfg.get("layers_per_block", 2), attention_head_dim=head_dim_of(ucfg),
        cross_attention_dim=ucfg.get("cross_attention_dim", 1024),
        norm_groups=ucfg.get("norm_num_groups", 32), device="meta"), unet_sd)
    vcfg = _json(os.path.join(ref_dir, "vae", "config.json"))
    vae = _loaded(AutoencoderKL(
        latent_channels=vcfg.get("latent_channels", 4),
        block_out_channels=tuple(vcfg.get("block_out_channels", (128, 256, 512, 512))),
        norm_groups=vcfg.get("norm_num_groups", 32), device="meta"),
        vae_state_dict(load_torch_state_dict(os.path.join(ref_dir, "vae"))))

    te_dir = os.path.join(ref_dir, "text_encoder")
    if os.path.exists(te_dir):
        text_embed = text_embedding(te_dir, device)
        print("computed empty-prompt embedding from text_encoder")
    else:
        text_embed = torch.zeros((1, 2, ucfg.get("cross_attention_dim", 1024)))
        print("WARNING: no text_encoder dir; zero text embedding")
    return GuidedLatentDiffusionPipeline(
        unet=unet, vae=vae, text_embed=text_embed, spec=spec, guidance=guidance,
        normalizer=Normalizer(ssi=False, mode="average", num_chs=1, ch_bounds=(128.0,),
                              ch_gammas=(1.0,)),
        device="cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.import_reference")
    p.add_argument("ref_dir")
    p.add_argument("out_dir")
    p.add_argument("--cond-channels", default=None,
                   help="widen conv_in for this combination when importing a bare SD2.1 "
                        "unet (reference: train.py:751-772)")
    p.add_argument("--device", default=None,
                   help="torch device of the text tower (default: cuda)")
    args = p.parse_args(argv)
    pipe = import_reference(args.ref_dir, args.cond_channels, args.device)
    pipe.save_pretrained(args.out_dir)
    kind = "LDM" if isinstance(pipe, GuidedLatentDiffusionPipeline) else "pixel"
    print(f"imported {kind} pipeline -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
