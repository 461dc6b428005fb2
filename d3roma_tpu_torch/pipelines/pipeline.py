"""The diffusion pipelines: the pixel-space one (UNet2D + sampler +
guidance + normalizer) and the latent one (UNet + VAE + the baked
empty-prompt embedding + sampler + normalizer), with the JAX package's
directory format.

Port of `d3roma_tpu/pipelines/pipeline.py`. `GuidedDiffusionPipeline`:
`__call__` (every sampler, imputation guidance), `half_precision`,
`quantize_int8`, `fuse_norms`, `replace_sampler`, `save_pretrained` /
`from_pretrained`. `GuidedLatentDiffusionPipeline`:
`__call__` (with the gradient guidance and add_noise_rgb), `half_precision`,
`quantize_int8` (dynamic int8 in the UNet and the VAE),
`fast_inference("latency")` (bf16 weights, the whole-row attention kernel at
self-attention sites of >= 512 tokens, the fused GEGLU kernel),
`fast_inference("throughput")` (the same with the static int8 mode in the
UNet and the VAE), `fast_inference("dense")` (the same with dynamic int8 at
the dense layers only), `fast_inference("wino")` (the same with the
"wino_static" mode: Winograd at the convs it routes there), `fuse_norms`,
`deepcache`, `calibrate` (with optional |activation| quantiles),
`quant_call_map`, `kind_pins`, `with_act_clipping`, `replace_sampler` and
`save_pretrained` / `from_pretrained`. Split programs / scan chunks and the
compiled-program cache are not ported and raise NotImplementedError.

Unlike the JAX package's, whose methods return a replaced copy, these
pipelines' configuration methods (`half_precision`, `quantize_int8`,
`set_quant`, `fast_inference`, `fuse_norms`, `deepcache`, `calibrate`,
`with_act_clipping`, `replace_sampler`) change the pipeline (and its
models) in place and return it: a caller that derives several
configurations from one base pipeline copies it first. `quant_call_map`
and `kind_pins` change nothing.

A pipeline directory is the JAX package's: `model_index.json` (the
pipeline class, the sampler, the guidance and normalizer fields), one
folder per model with `config.json` and `params.msgpack` (the Flax param
tree, read and written by `utils/flax_msgpack.py`), and for the latent
pipeline `text_embed.npy` and, when calibrated, `act_scales.json`. Either
package reads what the other writes. A model whose saved params are all
bf16 (a half-precision pipeline's) loads in bf16.

`act_scales` keeps the JAX package's JSON form: tables "unet",
"unet_cached", "vae_encode", "vae_decode" (and "<table>@pins"), lists of
floats in call order; after `calibrate(quantiles=...)` also "<table>@q"
(each call's [absmax, q...]/127) and "@quantiles". Each forward replays its
table in its own context.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from d3roma_tpu_torch.device import DeviceLike, resolve_device
from d3roma_tpu_torch.guidance import FlowGuidance, frozen_parameters
from d3roma_tpu_torch.models.convert import (
    flax_unet2d_to_torch,
    flax_unet_to_torch,
    flax_vae_to_torch,
    torch_to_flax,
)
from d3roma_tpu_torch.models.layers import _Cached, module_dtype
from d3roma_tpu_torch.models.unet2d import UNet2D
from d3roma_tpu_torch.models.unet2d_condition import UNet2DCondition
from d3roma_tpu_torch.models.vae import AutoencoderKL, decode_latent, encode_image_to_latent
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.quant import (
    STATIC_MODES,
    capture_act_scales,
    replay_act_scales,
    stack_taps,
)
from d3roma_tpu_torch.ops.scheduler_step import ddim_step
from d3roma_tpu_torch.ops.schedules import ScheduleConfig, set_timesteps
from d3roma_tpu_torch.parallel.mesh import broadcast_object
from d3roma_tpu_torch.pipelines.sampling import (
    PipelineOutput,
    SamplerSpec,
    latent_decode_images,
    latent_denoise,
    latent_encode_conds,
    pixel_pipeline,
    step_pattern,
)
from d3roma_tpu_torch.utils import flax_msgpack

ACT_TABLES = ("unet", "unet_cached", "vae_encode", "vae_decode")
# the config.json keys of each model, as the JAX package's save_pretrained writes them
UNET2D_CONFIG = ("in_channels", "out_channels", "block_out_channels", "down_block_types",
                 "up_block_types", "layers_per_block", "attention_head_dim", "norm_groups")
UNET_CONFIG = ("in_channels", "out_channels", "block_out_channels", "down_block_types",
               "up_block_types", "layers_per_block", "attention_head_dim",
               "cross_attention_dim", "norm_groups")
VAE_CONFIG = ("in_channels", "out_channels", "latent_channels", "block_out_channels",
              "norm_groups")


def _save_module(path: str, model: torch.nn.Module, keys, state=None) -> None:
    """The model's directory; `state` in place of its state dict (a
    tensor-parallel model's, gathered)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({k: getattr(model, k) for k in keys}, f, indent=2)
    flax_msgpack.dump(torch_to_flax(model.state_dict() if state is None else state),
                      os.path.join(path, "params.msgpack"))


def _load_module(path: str, make, to_torch, device) -> torch.nn.Module:
    """Build the model from `config.json` on `device` and load
    `params.msgpack` into it (strict, names mapped by `to_torch`): in bf16
    when every floating leaf is bf16 (a half-precision pipeline's), else in
    fp32, other leaves (an fp16 reference import's) widened as the JAX
    package's fp32 modules widen them."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    for k in ("block_out_channels", "down_block_types", "up_block_types"):
        if k in config:
            config[k] = tuple(config[k])
    state = to_torch(flax_msgpack.load(os.path.join(path, "params.msgpack")))
    model = make(**config, device=device)
    if {t.dtype for t in state.values() if t.is_floating_point()} == {torch.bfloat16}:
        model.to(torch.bfloat16)
    model.load_state_dict(state, strict=True)
    return model


def _meta(pipeline_class: str, spec: SamplerSpec, guidance: Optional[FlowGuidance],
          normalizer: Normalizer) -> dict:
    return {"pipeline_class": pipeline_class,
            "scheduler": {"kind": spec.kind, "eta": spec.eta,
                          "use_clipped_model_output": spec.use_clipped_model_output,
                          "schedule": dataclasses.asdict(spec.schedule)},
            "guidance": dataclasses.asdict(guidance or FlowGuidance(flow_guidance_weight=0.0)),
            "normalizer": dataclasses.asdict(normalizer)}


def _read_meta(out_dir: str, pipeline_class: str):
    """(spec, guidance, normalizer) of a directory's model_index.json."""
    with open(os.path.join(out_dir, "model_index.json")) as f:
        meta = json.load(f)
    if meta.get("pipeline_class", pipeline_class) != pipeline_class:
        raise ValueError(f"{out_dir} holds a {meta['pipeline_class']}, not a {pipeline_class}")
    sch = meta["scheduler"]
    spec = SamplerSpec(kind=sch["kind"], eta=sch["eta"],
                       use_clipped_model_output=sch["use_clipped_model_output"],
                       schedule=ScheduleConfig(**sch["schedule"]))
    norm = dict(meta["normalizer"])
    for k in ("ch_bounds", "ch_gammas"):
        norm[k] = tuple(norm[k])
    return spec, FlowGuidance(**meta["guidance"]), Normalizer(**norm)


@dataclasses.dataclass
class GuidedDiffusionPipeline:
    """The pixel-space pipeline. The UNet is moved to `device` (CUDA unless
    the caller names another) when the pipeline is made."""

    unet: UNet2D
    spec: SamplerSpec
    guidance: FlowGuidance
    normalizer: Normalizer
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.unet.to(self.device)
        self._tables = self.spec.schedule.tables(self.device)

    def replace_sampler(self, spec: SamplerSpec) -> "GuidedDiffusionPipeline":
        """Another sampler (and schedule) for the same model. In place."""
        self.spec = spec
        self._tables = spec.schedule.tables(self.device)
        return self

    def half_precision(self) -> "GuidedDiffusionPipeline":
        """Inference-only bf16 weights (conv_out still computes in fp32).
        In place."""
        self.unet.to(torch.bfloat16)
        return self

    def set_quant(self, quant) -> "GuidedDiffusionPipeline":
        """The UNet's int8 mode (one of ops/quant.py's QUANT_MODES)."""
        self.unet.set_quant(quant)
        return self

    def quantize_int8(self) -> "GuidedDiffusionPipeline":
        """Dynamic int8 (quant=True): every resnet and resampler conv and
        attention projection takes its own per-row or per-item activation
        scale on the device and runs the dynamic int8 kernel. In place."""
        return self.set_quant(True)

    def fuse_norms(self) -> "GuidedDiffusionPipeline":
        """The fused GroupNorm + SiLU kernel at the resnets' norms and
        conv_norm_out, where its gate admits the shape. In place."""
        self.unet.set_kernels(fused_norm=True)
        return self

    def __call__(
        self,
        num_inference_steps: int,
        num_intermediate_images: int,
        depth_channels: int,
        cond_channels: str,
        rgb_images: Optional[torch.Tensor] = None,
        left_images: Optional[torch.Tensor] = None,
        right_images: Optional[torch.Tensor] = None,
        sim_disp: Optional[torch.Tensor] = None,
        raw_mask: Optional[torch.Tensor] = None,
        add_noise_rgb: bool = False,
        generator: Optional[torch.Generator] = None,
        x_init: Optional[torch.Tensor] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        rgb_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> PipelineOutput:
        """Restore disparity from the conditions (NHWC, in [-1, 1], the
        normalized raw disparity as `sim_disp`): the sampler from `x_init`
        (or noise drawn from `generator`), its per-step noise `step_noise`
        and, with `add_noise_rgb`, the rgb condition's `rgb_noise` (or drawn
        from `generator`). Returns the final sample and the kept
        x_hat0s, clamped to [-1, 1]; `self.normalizer.denormalize` turns
        them into disparity."""
        def on_device(x):
            return None if x is None else torch.as_tensor(x).to(self.device)

        with torch.no_grad():
            return pixel_pipeline(
                self.unet, self.spec, self._tables, num_inference_steps,
                num_intermediate_images, depth_channels, cond_channels,
                rgb=on_device(rgb_images), left=on_device(left_images),
                right=on_device(right_images), sim_disp=on_device(sim_disp),
                guidance=self.guidance, raw_mask=on_device(raw_mask),
                add_noise_rgb=add_noise_rgb, generator=generator,
                x_init=on_device(x_init),
                step_noise=None if step_noise is None else [on_device(n) for n in step_noise],
                rgb_noise=None if rgb_noise is None else [on_device(n) for n in rgb_noise])

    def save_pretrained(self, out_dir: str, states: Optional[dict] = None) -> None:
        """Write the JAX package's pixel pipeline directory (`states`:
        {"unet": state dict} in place of the model's own)."""
        os.makedirs(out_dir, exist_ok=True)
        _save_module(os.path.join(out_dir, "unet"), self.unet, UNET2D_CONFIG,
                     (states or {}).get("unet"))
        with open(os.path.join(out_dir, "model_index.json"), "w") as f:
            json.dump(_meta("GuidedDiffusionPipeline", self.spec, self.guidance,
                            self.normalizer), f, indent=2)

    @classmethod
    def from_pretrained(cls, out_dir: str, device: DeviceLike = None) -> "GuidedDiffusionPipeline":
        """Load a pixel pipeline directory written by either package."""
        device = resolve_device(device)
        spec, guidance, normalizer = _read_meta(out_dir, "GuidedDiffusionPipeline")
        unet = _load_module(os.path.join(out_dir, "unet"), UNet2D, flax_unet2d_to_torch, device)
        return cls(unet=unet, spec=spec, guidance=guidance, normalizer=normalizer,
                   device=device)


@dataclasses.dataclass
class GuidedLatentDiffusionPipeline:
    """The models are moved to `device` (CUDA unless the caller names
    another) when the pipeline is made."""

    unet: UNet2DCondition
    vae: AutoencoderKL
    text_embed: torch.Tensor  # [1, T, cross_attention_dim]
    spec: SamplerSpec
    normalizer: Normalizer
    device: DeviceLike = None
    # the in-step guidance, run where a call passes raw_depth
    guidance: Optional[FlowGuidance] = None
    # calibrated static-int8 activation scales (see the module docstring)
    act_scales: Optional[Dict[str, list]] = None
    # DeepCache: groups of one full and cache_interval - 1 shallow passes,
    # or an explicit F/S step pattern (which overrides the interval)
    cache_interval: int = 1
    cache_schedule: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.unet.to(self.device)
        self.vae.to(self.device)
        self.text_embed = torch.as_tensor(self.text_embed).to(self.device)
        self._tables = self.spec.schedule.tables(self.device)

    def replace_sampler(self, spec: SamplerSpec) -> "GuidedLatentDiffusionPipeline":
        """Another sampler (and schedule) for the same models. In place."""
        if spec.kind == "heun" and self.cache_active:
            raise ValueError("deepcache does not support the heun sampler")
        self.spec = spec
        self._tables = spec.schedule.tables(self.device)
        return self

    def half_precision(self) -> "GuidedLatentDiffusionPipeline":
        """Inference-only bf16 weights. Casts the UNet and the VAE in place
        (PyTorch's Module.to) and returns this pipeline."""
        self.unet.to(torch.bfloat16)
        self.vae.to(torch.bfloat16)
        return self

    def set_quant(self, quant) -> "GuidedLatentDiffusionPipeline":
        """The int8 mode (one of ops/quant.py's QUANT_MODES) of the UNet and
        the VAE."""
        self.unet.set_quant(quant)
        self.vae.set_quant(quant)
        return self

    def quantize_int8(self) -> "GuidedLatentDiffusionPipeline":
        """Dynamic int8 (quant=True) in the UNet and the VAE: every dense
        layer and convolution of their quantized sites takes its own
        per-row or per-batch-item activation scale, computed on the device;
        the whole-row attention sites run the int8 kernel. In place."""
        return self.set_quant(True)

    def fast_inference(self, mode: str = "throughput") -> "GuidedLatentDiffusionPipeline":
        """"latency": bf16 weights, the whole-row attention kernel at the
        self-attention sites of >= 512 tokens, the fused GEGLU kernel in
        every transformer block, no int8. "throughput": the same with the
        static int8 mode in the UNet and the VAE (the int8 attention, GEGLU
        and conv kernels). "wino": the same with the "wino_static" mode (the
        Winograd kernel at the stride-1 3x3 convs ops/winograd.py routes
        there, static int8 elsewhere). "dense": the latency kernels with
        dynamic int8 at the dense layers only (the attention sites take the
        bf16 kernel, the feed-forwards run unfused). "off" returns the
        pipeline unchanged."""
        if mode in ("off", "", None):
            return self
        quant = {"latency": False, "throughput": "static", "wino": "wino_static",
                 "dense": "dense"}.get(mode, None)
        if quant is None:
            raise ValueError(f"unknown fast_inference mode {mode!r}")
        pipe = self.half_precision()
        pipe.unet.set_kernels(use_flash_attention="pallas-self", fused_ff=True)
        return pipe.set_quant(quant)

    def fuse_norms(self) -> "GuidedLatentDiffusionPipeline":
        """The fused GroupNorm + SiLU kernel at the resnets' norms (and the
        UNet's conv_norm_out) of the UNet and the VAE, where its gate admits
        the shape."""
        self.unet.set_kernels(fused_norm=True)
        self.vae.set_kernels(fused_norm=True)
        return self

    def deepcache(self, interval=2, depth: Optional[int] = None) -> "GuidedLatentDiffusionPipeline":
        """Enable DeepCache: each group of `interval` denoise steps runs one
        full UNet pass (which also returns its trunk) and interval - 1
        shallow passes on that trunk. `interval` may instead be an F/S
        pattern string (e.g. "FSFSFSFSFF"). `depth` (default: keep the
        UNet's) is the shallow pass's depth. Calibrated tables depend on the
        schedule and the depth: calibrate after changing either."""
        if depth is not None:
            self.unet.cache_depth = int(depth)
        if isinstance(interval, str):
            s = interval.strip().upper()
            if not s or set(s) - {"F", "S"} or s[0] != "F":
                raise ValueError(f"cache schedule must be a nonempty F/S string starting "
                                 f"with F, got {interval!r}")
            if "S" in s and self.spec.kind == "heun":
                raise ValueError("deepcache does not support the heun sampler")
            self.cache_schedule, self.cache_interval = s, 1
            return self
        interval = int(interval)
        if interval < 1:
            raise ValueError(f"cache_interval must be >= 1, got {interval}")
        if interval > 1 and self.spec.kind == "heun":
            raise ValueError("deepcache does not support the heun sampler")
        self.cache_interval, self.cache_schedule = interval, None
        return self

    @property
    def cache_active(self) -> bool:
        """True when any denoise step runs the shallow cached pass."""
        return self.cache_interval > 1 or bool(
            self.cache_schedule and "S" in self.cache_schedule.upper())

    def _replayed(self, fn, table: str):
        """`fn` with its static int8 ops taking the `table` scales, one
        replay context per call (no-op without a table, or where the
        table's model is in no static mode and so consumes no scale)."""
        scales = (self.act_scales or {}).get(table)
        model = self.vae if table.startswith("vae") else self.unet
        if not scales or model.quant not in STATIC_MODES:
            return fn
        pins = (self.act_scales or {}).get(table + "@pins") or ()

        def wrapped(*args):
            with replay_act_scales(scales, pins=pins):
                return fn(*args)
        return wrapped

    def _unet_cache_fns(self):
        """(trunk_apply, cached_apply) of the DeepCache path, or (None,
        None) without it; each pass replays its own table ("unet" for the
        full pass, "unet_cached" for the shallow one)."""
        if not self.cache_active:
            return None, None
        tabs = self.act_scales or {}
        if tabs.get("unet") and self.unet.quant in STATIC_MODES and not tabs.get("unet_cached"):
            raise ValueError(
                "deepcache with calibrated static int8 needs the 'unet_cached' scale "
                "table: re-run calibrate() (it captures both passes); replaying the "
                "full-pass table against the shallow pass's different call order "
                "would misassign every per-layer scale")

        def trunk_apply(model_input, t, ctx):
            return self.unet(model_input, t, ctx, return_trunk=True)

        def cached_apply(model_input, t, ctx, trunk):
            return self.unet(model_input, t, ctx, cached_trunk=trunk)

        return self._replayed(trunk_apply, "unet"), self._replayed(cached_apply, "unet_cached")

    def calibrate(self, generator: Optional[torch.Generator], batches,
                  cond_channels: str = "rgb+raw", num_inference_steps: int = 10,
                  margin: float = 1.25, quantiles: Optional[Sequence[float]] = None,
                  shape_logs: Optional[Dict[str, list]] = None) -> "GuidedLatentDiffusionPipeline":
        """Calibrate the static int8 activation scales and keep them in
        `act_scales` (the UNet and the VAE are switched to quant="static"
        first if the UNet is in no static mode, as the JAX package does:
        so a pipeline with a bf16 UNet and a static VAE, the JAX bench's
        "vae8", runs static int8 in both after calibration).

        Capture passes record absmax(x)/127 at every quantized site, in call
        order, with the ops in float: one stacked VAE encode of the
        conditions; the UNet along a `num_inference_steps` DDIM trajectory
        from noise, following the deployed F/S pattern (shallow steps see
        the stale trunk of their group's full step; without any shallow
        step, each step also captures the shallow pass on its own trunk);
        the decode of the final x_hat0 and of the raw condition's latent.
        Each table is the maximum over `batches` times `margin`. Under a
        tensor-parallel mesh (`tp_mesh`) every rank captures the same taps
        and keeps rank 0's tables.

        `quantiles` (e.g. (0.999,)): each tap also records those quantiles
        of |x| (ops/quant.py::abs_quantiles); the tables stay absmax-based,
        and the raw per-call [absmax, q...]/127 rows are kept under
        "<table>@q", the quantiles under "@quantiles", for
        `with_act_clipping`.

        `batches`: dicts with the __call__ condition tensors (rgb_images,
        left_images, right_images, sim_disp) and optionally `latents`, the
        initial noise (else drawn from `generator`, fp32). `shape_logs`, a
        dict, receives each table's (kind, shape) per call of the first
        batch."""
        if self.unet.quant not in STATIC_MODES:
            self.set_quant("static")
        tabs: Dict[str, Optional[np.ndarray]] = {k: None for k in ACT_TABLES}
        width = 1 + len(quantiles or ())

        def capture(table, fn, *args):
            taps: list = []
            log = [] if shape_logs is not None and table not in shape_logs else None
            with capture_act_scales(taps, shape_log=log, quantiles=quantiles):
                out = fn(*args)
            if log is not None:
                shape_logs[table] = log
            arr = stack_taps(taps, width)
            tabs[table] = arr if tabs[table] is None else np.maximum(tabs[table], arr)
            return out

        cfg = self.spec.schedule
        ts = set_timesteps(cfg, num_inference_steps)
        step_ratio = cfg.num_train_timesteps // num_inference_steps
        pattern = step_pattern(len(ts), self.cache_interval, self.cache_schedule)
        dual_capture = pattern is None
        pattern = pattern or "F" * len(ts)

        def encode(x):
            return encode_image_to_latent(self.vae, x)

        def decode(z):
            return decode_latent(self.vae, z)

        with torch.no_grad():
            for b in batches:
                conds_in = {k: None if b.get(name) is None
                            else torch.as_tensor(b[name]).to(self.device, torch.float32)
                            for k, name in (("rgb", "rgb_images"), ("left", "left_images"),
                                            ("right", "right_images"), ("sim_disp", "sim_disp"))}
                conds, lat = capture("vae_encode", latent_encode_conds, encode, cond_channels,
                                     *conds_in.values())
                shape = tuple(conds.shape[:-1]) + (4,)
                if b.get("latents") is not None:
                    x = torch.as_tensor(b["latents"]).to(self.device, torch.float32)
                else:
                    x = torch.randn(shape, generator=generator, device=self.device)
                x0 = x
                ctx = self.text_embed.expand((shape[0],) + tuple(self.text_embed.shape[1:]))
                trunk = None
                for i, t in enumerate(ts):
                    t = int(t)
                    model_input = torch.cat([x, conds], dim=-1)
                    if pattern[i] == "S":
                        out = capture("unet_cached", self.unet, model_input, t, ctx, trunk)
                    else:
                        out, trunk = capture("unet", self.unet, model_input, t, ctx, None, True)
                        if dual_capture:
                            capture("unet_cached", self.unet, model_input, t, ctx, trunk)
                    step = ddim_step(self._tables, cfg, out, t, t - step_ratio, x)
                    x, x0 = step.prev_sample, step.pred_original_sample
                capture("vae_decode", decode, x0)
                if "raw" in lat:  # intermediates also decode the condition's latent
                    capture("vae_decode", decode, lat["raw"])

        act_scales: Dict[str, list] = {}
        for k, tab in tabs.items():
            if tab is None or not tab.size:
                continue
            absmax = tab[:, 0] if quantiles else tab
            act_scales[k] = [float(max(v * margin, 1e-8)) for v in absmax]
            if quantiles:
                act_scales[k + "@q"] = [[float(x) for x in row] for row in tab]
        if quantiles:
            act_scales["@quantiles"] = [float(q) for q in quantiles]
        if self.unet.tp_mesh is not None:  # every rank replays rank 0's table
            act_scales = broadcast_object(act_scales, self.unet.tp_mesh)
        self.act_scales = act_scales
        return self

    def quant_call_map(self, batch: int = 16, height: int = 360,
                       width: int = 640) -> Dict[str, list]:
        """The static-int8 call order, {"unet": [(kind, shape), ...],
        "unet_cached": [...]}, kind one of "dot", "conv", "attn", "geglu":
        which layer each index of a replay table belongs to, for a call at
        `batch` x `height` x `width` (the gates are shape-dependent: give
        the deployment's shapes, as to calibrate()).

        From an abstract capture trace of a full and a shallow UNet pass:
        a replica of the UNet on the meta device (no weight copied, no data
        read, nothing launched), switched to "static" if the UNet is in no
        static mode, as the JAX package's `jax.eval_shape` trace is. The
        replica's attention and GroupNorm sites take their plain versions
        (their kernels take no tap, so the call order is the same; the
        fused self-attention, which takes one, runs its capture math
        inline, as it does under calibration). The pipeline is not
        changed."""
        unet = _meta_replica(self.unet)
        if unet.quant not in STATIC_MODES:
            unet.set_quant("static")
        route = unet.use_flash_attention
        unet.set_kernels(use_flash_attention="fused" if route == "fused" else False,
                         fused_norm=False)
        dt = module_dtype(unet.conv_in)
        x = torch.empty((batch, height // 8, width // 8, unet.in_channels), dtype=dt,
                        device="meta")
        t = torch.empty((batch,), dtype=torch.int32, device="meta")
        ctx = torch.empty((batch,) + tuple(self.text_embed.shape[1:]), dtype=dt,
                          device="meta")
        logs: Dict[str, list] = {"unet": [], "unet_cached": []}
        with torch.no_grad():
            with capture_act_scales([], shape_log=logs["unet"]):
                _, trunk = unet(x, t, ctx, return_trunk=True)
            with capture_act_scales([], shape_log=logs["unet_cached"]):
                unet(x, t, ctx, cached_trunk=trunk)
        return logs

    def kind_pins(self, kinds, batch: int = 16, height: int = 360,
                  width: int = 640) -> Dict[str, List[int]]:
        """The pins ({table: [call indices]}, `with_act_clipping`'s form)
        of every "unet" and "unet_cached" call whose kind is in `kinds`
        ("dot", "conv", "attn", "geglu"): those calls then run in float at
        replay (a per-layer-class ablation of the int8 drift)."""
        kinds = frozenset(kinds)
        return {tab: [i for i, (kind, _) in enumerate(log) if kind in kinds]
                for tab, log in self.quant_call_map(batch, height, width).items()}

    def with_act_clipping(self, percentile: Optional[float] = None, margin: float = 1.25,
                          pins: Optional[Dict[str, Sequence[int]]] = None
                          ) -> "GuidedLatentDiffusionPipeline":
        """Re-derive the replay tables from a quantile-recording calibration
        (calibrate(quantiles=...)), without a new capture. `percentile`: one
        of the captured quantiles to set each scale at (times `margin`), or
        None for absmax; with None and a margin other than 1.25, the tables
        are re-derived from the recorded absmax at that margin. `pins`:
        {table: [call indices]} to run in float at replay, kept as
        "<table>@pins" (earlier pins are dropped). In place."""
        if not self.act_scales:
            raise ValueError("calibrate() first")
        new = {k: v for k, v in self.act_scales.items() if not k.endswith("@pins")}
        has_q = any(k.endswith("@q") for k in new)
        if percentile is not None:
            qlist = [float(q) for q in self.act_scales.get("@quantiles") or ()]
            if float(percentile) not in qlist:
                raise ValueError(f"percentile {percentile} not captured; available: {qlist} "
                                 f"(re-run calibrate(quantiles=...))")
            col = 1 + qlist.index(float(percentile))
        elif has_q and margin != 1.25:
            col = 0
        else:
            col = None
        if col is not None:
            for k in [k for k in new if k.endswith("@q")]:
                new[k[:-2]] = [float(max(row[col] * margin, 1e-8)) for row in new[k]]
        for name, idx in (pins or {}).items():
            if new.get(name):
                new[name + "@pins"] = sorted(int(i) for i in idx)
        self.act_scales = new
        return self

    def __call__(
        self,
        num_inference_steps: int,
        num_intermediate_images: int,
        cond_channels: str,
        rgb_images: Optional[torch.Tensor] = None,
        left_images: Optional[torch.Tensor] = None,
        right_images: Optional[torch.Tensor] = None,
        sim_disp: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        raw_depth=None,
        denormer=None,
        denorm_builder=None,
        add_noise_rgb: bool = False,
        split_programs: bool = False,
        scan_chunk: Optional[int] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        denorm_mask=None,
        rgb_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> PipelineOutput:
        """Restore disparity from the conditions (NHWC, in [-1, 1]): encode
        them once, run the sampler from `latents` (or noise drawn from
        `generator`), with the per-step noise `step_noise` (and, with
        `add_noise_rgb`, the rgb condition's `rgb_noise`; else drawn from
        `generator`), and decode. Returns the decoded final x_hat0 in
        [-1, 1]; `self.normalizer.denormalize` turns it into disparity.

        With `raw_depth` (the unnormalized raw disparity [B, H, W, 1]) and
        an enabled `self.guidance`, every step runs the gradient guidance
        (ODE samplers only) through the VAE decode, each decode replaying
        the "vae_decode" table from its start, and a denormalizer:
        `denormer(x)`, or `denorm_builder(x, raw_depth, denorm_mask)`."""
        if denormer is not None and denorm_builder is not None:
            raise ValueError("pass denormer or denorm_builder, not both")
        if split_programs or scan_chunk:
            raise NotImplementedError("split_programs / scan_chunk are not ported")

        def on_device(x):
            return None if x is None else torch.as_tensor(x).to(self.device)

        rgb, left, right, raw = map(on_device, (rgb_images, left_images, right_images,
                                                sim_disp))
        ref = next(x for x in (rgb, left, right, raw) if x is not None)
        trunk_apply, cached_apply = self._unet_cache_fns()
        guidance_fn = self._guidance_fn(on_device(raw_depth), denormer, denorm_builder,
                                        on_device(denorm_mask))
        with torch.no_grad():
            conds, lat = latent_encode_conds(
                self._replayed(lambda x: encode_image_to_latent(self.vae, x), "vae_encode"),
                cond_channels, rgb=rgb, left=left, right=right, sim_disp=raw)
            kept = latent_denoise(
                self._replayed(self.unet, "unet"), self.text_embed, self.spec, self._tables,
                num_inference_steps, num_intermediate_images, conds, lat,
                cond_channels, generator=generator, latents=latents,
                noise_dtype=ref.dtype, cache_interval=self.cache_interval,
                unet_apply_trunk=trunk_apply, unet_apply_cached=cached_apply,
                cache_schedule=self.cache_schedule,
                step_noise=None if step_noise is None else [on_device(n) for n in step_noise],
                guidance_fn=guidance_fn, add_noise_rgb=add_noise_rgb,
                rgb_noise=None if rgb_noise is None else [on_device(n) for n in rgb_noise])
            return latent_decode_images(
                self._replayed(lambda z: decode_latent(self.vae, z), "vae_decode"), kept)

    def _guidance_fn(self, raw_depth, denormer, denorm_builder, mask):
        """The steps' gradient guidance hook, or None without raw_depth or
        an enabled guidance (the JAX package's `_guidance_fn`). Its decoder
        is the replayed "vae_decode", with the VAE's parameters out of
        autograd (only the latent is differentiated)."""
        if raw_depth is None or self.guidance is None or not self.guidance.enabled:
            return None
        if not self.spec.is_ode:
            raise ValueError(f"in-step guidance runs only with the deterministic samplers "
                             f"(ddim, my_ddim, euler, heun), not {self.spec.kind!r}")
        if denorm_builder is not None:
            def denormer(x):
                return denorm_builder(x, raw_depth, mask)
        if denormer is None:
            raise ValueError("guidance needs a denormer or a denorm_builder")
        decode = self._replayed(lambda z: decode_latent(self.vae, z), "vae_decode")

        def decoder(z):
            with frozen_parameters(self.vae):
                return decode(z)

        return self.guidance.make_latent_guidance_fn(decoder, denormer, raw_depth)

    def save_pretrained(self, out_dir: str, states: Optional[dict] = None) -> None:
        """Write the JAX package's latent pipeline directory (`states`:
        {"unet": ..., "vae": ...} state dicts in place of the models' own,
        as a tensor-parallel run gathers them)."""
        os.makedirs(out_dir, exist_ok=True)
        states = states or {}
        _save_module(os.path.join(out_dir, "unet"), self.unet, UNET_CONFIG, states.get("unet"))
        _save_module(os.path.join(out_dir, "vae"), self.vae, VAE_CONFIG, states.get("vae"))
        embed = self.text_embed.detach().cpu()
        # numpy has no bfloat16: a bf16 embedding is saved widened
        np.save(os.path.join(out_dir, "text_embed.npy"),
                (embed.float() if embed.dtype == torch.bfloat16 else embed).numpy())
        with open(os.path.join(out_dir, "model_index.json"), "w") as f:
            json.dump(_meta("GuidedLatentDiffusionPipeline", self.spec, self.guidance,
                            self.normalizer), f, indent=2)
        if self.act_scales:
            with open(os.path.join(out_dir, "act_scales.json"), "w") as f:
                json.dump(self.act_scales, f)

    @classmethod
    def from_pretrained(cls, out_dir: str,
                        device: DeviceLike = None) -> "GuidedLatentDiffusionPipeline":
        """Load a latent pipeline directory written by either package."""
        device = resolve_device(device)
        spec, guidance, normalizer = _read_meta(out_dir, "GuidedLatentDiffusionPipeline")
        act_scales = None
        path = os.path.join(out_dir, "act_scales.json")
        if os.path.exists(path):
            with open(path) as f:
                act_scales = json.load(f)
        return cls(unet=_load_module(os.path.join(out_dir, "unet"), UNet2DCondition,
                                     flax_unet_to_torch, device),
                   vae=_load_module(os.path.join(out_dir, "vae"), AutoencoderKL,
                                    flax_vae_to_torch, device),
                   text_embed=torch.from_numpy(np.load(os.path.join(out_dir, "text_embed.npy"))),
                   spec=spec, normalizer=normalizer, device=device, guidance=guidance,
                   act_scales=act_scales)


def _meta_replica(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` whose parameters and buffers are meta tensors of
    the same shapes and dtypes (no data copied) and whose cached kernel
    operands start empty: forwards through it compute shapes only."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = t.detach().to("meta")
        memo[id(t)] = torch.nn.Parameter(meta, requires_grad=False) \
            if isinstance(t, torch.nn.Parameter) else meta
    for m in module.modules():
        for v in vars(m).values():
            if isinstance(v, _Cached):
                memo[id(v)] = _Cached(v._make)
    return copy.deepcopy(module, memo)


def create_sampler_spec(config, train: bool = True) -> SamplerSpec:
    """The sampler of a training config (reference: config.py:182-212).
    `schedule_config(train=...)` validates that only ddpm-family samplers
    are used for training; SamplerSpec rejects unknown kinds."""
    return SamplerSpec(
        kind=config.sampler,
        schedule=config.schedule_config(train=train),
        eta=float(getattr(config, "eta", 0.0)),
    )
