"""Configuration system: a single flat TrainingConfig + YAML task presets.

Port of `d3roma_tpu/config.py`: the same dataclasses, knob names and CLI
contract (``task=eval_ldm_mixed_rgb+raw task.eval_batch_size=2``). The
presets are the repository's `conf/task/*.yaml`, read in place. PyYAML is
not on the machine with the card: presets and override values go through
`utils/yaml_lite.py`, which returns what `yaml.safe_load` returns for the
subset of YAML the repository uses and raises, naming the line, for
anything else. The JAX module's `__main__` (a matplotlib figure of the
beta schedules) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from d3roma_tpu_torch.ops.schedules import ScheduleConfig
from d3roma_tpu_torch.utils import yaml_lite

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")

SUPPORTED_SAMPLERS = ("ddpm", "ddim", "my_ddpm", "my_ddim", "euler", "heun")


@dataclass
class Augment:
    """Data augmentation knobs (reference: config.py:21-33)."""

    resizedcrop: dict = field(
        default_factory=lambda: {
            "scale": [2, 2],
            "ratio": [1.3333333333333333, 1.3333333333333333],
        }
    )
    hflip: str = "h"
    min_scale: float = 0.0
    max_scale: float = 0.0
    saturation_range: List[float] = field(default_factory=lambda: [0, 1.4])
    gamma: List[float] = field(default_factory=lambda: [1, 1, 1, 1])
    yjitter: bool = False


@dataclass
class TrainingConfig:
    """The single flat config (reference: config.py:36-136). Field names are
    kept identical so reference task presets translate 1:1."""

    name: Optional[str] = "your task name here"
    tag: str = ""
    camera_resolution: str = "320x256"  # WxH dataset camera resolution
    image_size: Tuple[int, int] = (256, 320)  # (h, w) training image size
    divis_by: int = 32
    depth_channels: int = 1
    cond_channels: str = "rgb"  # rgb | rgb+raw | left+right(+raw) | rgb+left+right(+raw)
    train_batch_size: int = 12
    eval_batch_size: int = 12
    eval_num_batch: int = 2  # -1 evaluates the whole val set

    num_epochs: int = 1000
    gradient_accumulation_steps: int = 3
    clip_grad_norm: float = 1.0
    # "adamw" (reference parity) | "adafactor" (factored second moment —
    # fits the flagship 866M UNet's optimizer state on a single 16 GB
    # chip, where AdamW's 6.9 GB of f32 moments OOMs; see training/state.py)
    optimizer: str = "adamw"

    lr_warmup_steps: int = 500
    val_every_global_steps: int = 1000
    save_model_epochs: int = 10
    mixed_precision: str = "no"  # "no" (f32) | "bf16" (TPU-native AMP)
    # Inference-time kernel configuration for the latent pipeline (TPU):
    # "off" = plain XLA; "throughput" = measured-best batch config on v5e
    # (bf16 + whole-row Pallas self-attention + fused GEGLU FF + static
    # int8 MXU); "latency" = the batch-1/streaming config (same kernels,
    # no int8 — quantization is latency-bound at batch 1); "dense" =
    # latency kernels + dynamic int8 on the dense projections only (the
    # fastest COMPILABLE batch-1 config when the relay rejects the bf16
    # program — streaming/probe.py auto-selects it); "wino" =
    # throughput kernels with stride-1 3x3 convs on Winograd F(2x2,3x3)
    # (on-chip measurement pending). Numbers: docs/PERFORMANCE.md.
    fast_inference: str = "off"

    # DeepCache for latent-pipeline inference (Ma et al., CVPR 2024):
    # 1 = off; an interval k > 1 runs the full UNet on every k-th denoise
    # step and a shallow cached pass (deep-trunk reuse) between; an F/S
    # pattern STRING (e.g. "FSFSFSFSFF") selects a non-uniform schedule —
    # an accuracy/throughput trade measured in docs/PERFORMANCE.md.
    # Applies to inference/evaluate CLIs; heun is unsupported.
    deepcache: Any = 1
    # DeepCache shallow-pass depth: 1 = classic shallowest split; 2 =
    # medium split (also refreshes down block 1 + up block 2 — ~2/3 of
    # step FLOPs, lower drift). See models/unet2d_condition.py.
    deepcache_depth: int = 1

    # Run the latent pipeline as three jitted programs (VAE encode /
    # denoise scan / VAE decode) instead of one. Same math and steady-state
    # cost (the dispatches pipeline through the device queue); each program
    # is a fraction of the monolithic one's size, which matters when the
    # remote compile helper rejects very large programs (observed at
    # batch 1). Latency/streaming deployments should prefer it.
    split_programs: bool = False

    # Tensor-parallel degree for training: params sharded Megatron-style
    # on the `model` axis of a (data, model) mesh (parallel/tensor.py),
    # GSPMD collectives. 1 = pure DP (the reference's only mode). The
    # device count must be divisible by it.
    tensor_parallel: int = 1

    # Compiled-executable cache directory for serving (serving/aot.py):
    # restarts on the same device kind skip tracing AND XLA compilation
    # (a cold flagship compile through this environment's remote-compile
    # relay is 15-30 min). "" = off. Safe to enable always: any cache
    # failure falls back to the ordinary jit path.
    aot_cache: str = ""

    # With split_programs: additionally run the denoise scan as
    # ceil(S/scan_chunk) calls of ONE compiled scan_chunk-step program
    # (timestep slice is a traced argument; the carried x/PRNG key keeps
    # the result identical). 0 = whole scan in one program.
    scan_chunk: int = 0

    overwrite_output_dir: bool = True

    train_dataset: List[str] = field(default_factory=lambda: ["NYUv2"])
    eval_dataset: List[str] = field(default_factory=lambda: ["NYUv2"])
    dataset_weight: List[int] = field(default_factory=lambda: [1])
    dataset_variant: str = "default"

    # training settings
    ldm: bool = True
    prediction_space: str = "depth"  # "depth" | "disp"
    ssi: bool = False
    # normalizer
    normalize_mode: str = "average"
    num_chs: int = 3
    ch_bounds: List[float] = field(default_factory=lambda: [256, 256, 256])
    ch_gammas: List[float] = field(default_factory=lambda: [1 / 3.0, 1 / 3.0, 1 / 3.0])
    norm_t: float = 0.5
    norm_s: float = 2.0

    num_train_timesteps: int = 128
    num_inference_timesteps: int = 128
    num_inference_rounds: int = 1
    noise_strategy: str = "randn"  # "randn" | "pyramid"
    # training timestep sampler. "uniform" is the reference's behavior
    # (train.py:572,594 — its loss-second-moment sampler is updated but
    # only ever plotted); "loss-second-moment" importance-samples by the
    # tracked loss (ops/resample.py), kept as an opt-in
    timestep_sampler: str = "uniform"  # "uniform" | "loss-second-moment"
    loss_type: str = "l1"  # "l1" | "mse"
    learning_rate: float = 1e-4
    clip_gradient: bool = False

    # scheduler
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    num_cycles: int = 1
    beta_schedule: str = "squaredcos_cap_v2"
    beta_start: float = 1e-4
    beta_end: float = 2e-2
    noise_rgb: bool = False

    sampler: str = "my_ddpm"
    prediction_type: str = "v_prediction"
    # DDIM eta (stochasticity) for eval sampling; the reference's
    # MyDDIMScheduler.step takes eta per call with default 0
    # (scheduler_ddim.py:346) but exposes no config knob — here it is one.
    eta: float = 0.0

    # guidance
    flow_guidance_weights: List[float] = field(default_factory=lambda: [0.0])
    perturb_start_ratio: float = 1.0
    guide_source: Optional[str] = None  # "raw" | "stereo-match"
    flow_guidance_mode: str = "imputation"  # "imputation" | "gradient"

    # evaluation
    eval_output: str = ""
    eval_split: str = "val"
    write_pcd: bool = False
    num_intermediate_images: int = 8
    plot_mask: bool = False
    plot_error_map: bool = True
    plot_denoised_images: bool = True
    plot_intermediate_images: bool = False
    plot_intermediate_metrics: bool = False
    experiment_dir: str = "experiments"
    safe_ssi: bool = False
    # SSI normalization quantile window (0/1 = min/max, the reference's
    # effective behavior; robust settings like 0.02/0.98 ignore outliers)
    ssi_low_p: float = 0.0
    ssi_high_p: float = 1.0
    ransac_error_threshold: float = 0.6
    ensemble: bool = False
    coarse_to_fine: bool = False

    # resume
    resume_pretrained: Optional[str] = ""  # exported pipeline dir
    resume_ckpt: Optional[str] = ""  # orbax train-state dir

    output_dir: Optional[str] = ""

    augment: Augment = field(default_factory=Augment)

    # networks
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    lr_scheduler: Optional[str] = "cosine"

    # ------------------------------------------------------------------ #
    @property
    def image_hw(self) -> Tuple[int, int]:
        return int(self.image_size[0]), int(self.image_size[1])

    @property
    def camera_wh(self) -> Tuple[int, int]:
        w, h = self.camera_resolution.split("x")
        return int(w), int(h)

    def schedule_config(self, train: bool = True) -> ScheduleConfig:
        """Translate sampler knobs into a ScheduleConfig
        (reference: config.py:182-212)."""
        if self.sampler not in SUPPORTED_SAMPLERS:
            raise ValueError(f"Sampler not found: {self.sampler!r}")
        if train and self.sampler not in ("ddpm", "my_ddpm"):
            # reference: config.py:191-192 asserts DDIM is not for training;
            # the ODE samplers (euler/heun) are eval-only for the same reason
            raise AssertionError(
                f"sampler {self.sampler!r} should not be used for training "
                "(only ddpm/my_ddpm define the forward noising process)"
            )
        is_ddim = "ddim" in self.sampler
        return ScheduleConfig(
            num_train_timesteps=self.num_train_timesteps,
            beta_schedule=self.beta_schedule,
            beta_start=self.beta_start,
            beta_end=self.beta_end,
            prediction_type=self.prediction_type,
            clip_sample=self.clip_sample,
            clip_sample_range=self.clip_sample_range,
            thresholding=self.thresholding and not is_ddim,
            dynamic_thresholding_ratio=self.dynamic_thresholding_ratio,
            timestep_spacing="leading",
            steps_offset=1 if is_ddim else 0,
            set_alpha_to_one=False,
        )


@dataclass
class Config:
    """Root config (reference: config.py:139-143)."""

    debug: bool = False
    seed: int = -1
    task: TrainingConfig = field(default_factory=TrainingConfig)


def get_output_dir(base_config: Config) -> str:
    """Encode hyperparameters in the run name (reference: config.py:156-166)."""
    config = base_config.task
    ssi = "ssi" if config.ssi else "nossi"
    datasets = "_".join(config.train_dataset)
    weights = "_".join(format(x, ".1f") for x in config.flow_guidance_weights)
    tag = "" if config.tag == "" else f"-{config.tag}"
    return (
        f"{config.experiment_dir}/{config.name}{tag}.dep{config.depth_channels}"
        f".lr{config.learning_rate:.0e}.{config.prediction_type}.{ssi}"
        f".{config.beta_schedule}.{config.noise_strategy}"
        f".{config.sampler}{config.num_train_timesteps}"
        f".{datasets}.{config.image_size[0]}x{config.image_size[1]}"
        f".{config.cond_channels}.w{weights}"
        + ("_debug" if base_config.debug else "")
    )


def set_debug(config: TrainingConfig) -> None:
    """Debug-mode shrink (reference: config.py:168-180)."""
    config.val_every_global_steps = 10
    config.save_model_epochs = 1
    config.train_batch_size = 1
    config.eval_batch_size = 1
    config.beta_schedule = "linear"
    config.beta_start = 1e-4
    config.beta_end = 2e-1
    config.num_train_timesteps = 128
    config.num_inference_timesteps = 128
    config.num_intermediate_images = 4


# ---------------------------------------------------------------------- #
# YAML preset loading + dotted overrides (the Hydra-equivalent surface)
# ---------------------------------------------------------------------- #


def deepcache_active(dc) -> bool:
    """True when a task.deepcache value enables cached steps: an interval
    > 1 or a pattern string containing a shallow (S) step."""
    if isinstance(dc, str):
        return "S" in dc.upper()
    return int(dc) > 1


def _coerce(value: str) -> Any:
    """Parse a CLI override value: YAML-style scalars and lists."""
    try:
        return yaml_lite.loads(value)
    except yaml_lite.YamlError:
        return value


def _apply_to_dataclass(obj: Any, key: str, value: Any) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key: {key!r}")
    current = getattr(obj, leaf)
    if dataclasses.is_dataclass(current) and isinstance(value, dict):
        for k, v in value.items():
            _apply_to_dataclass(current, k, v)
    else:
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        # YAML 1.1 does not parse "2e-4" as a float (needs "2.0e-4"), so
        # scientific-notation overrides arrive as strings; coerce by the
        # target field's current type (hydra does the same by annotation)
        if isinstance(value, str) and isinstance(current, bool):
            value = value.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(value, str) and isinstance(current, float):
            try:
                value = float(value)
            except ValueError:
                pass
        elif (isinstance(value, str) and isinstance(current, int)
              and not isinstance(current, bool)):
            try:
                value = int(float(value))
            except ValueError:
                pass
        setattr(obj, leaf, value)


def _apply_preset_file(cfg: TrainingConfig, name: str, conf_dir: str) -> None:
    """Apply conf/task/<name>.yaml onto `cfg` IN PLACE: parents first (in
    listed order, Hydra semantics — later entries override earlier), then
    this file's own keys. Only keys a file explicitly sets are applied,
    so a second parent's dataclass DEFAULTS never clobber the first
    parent's explicit settings."""
    path = os.path.join(conf_dir, "task", f"{name}.yaml")
    data = yaml_lite.load_file(path) or {}
    parents = data.pop("defaults", [])
    if isinstance(parents, (str,)):
        parents = [parents]
    for parent in parents:
        if isinstance(parent, dict):
            continue  # hydra-style self-reference entries
        _apply_preset_file(cfg, str(parent), conf_dir)
    for k, v in data.items():
        _apply_to_dataclass(cfg, k, v)


def load_task_preset(name: str, conf_dir: Optional[str] = None) -> TrainingConfig:
    """Load conf/task/<name>.yaml onto TrainingConfig defaults. Supports the
    reference's ``defaults: [<parent>]`` inheritance used by eval presets."""
    cfg = TrainingConfig()
    _apply_preset_file(cfg, name, conf_dir or CONF_DIR)
    return cfg


def compose(
    overrides: Sequence[str] = (), conf_dir: Optional[str] = None
) -> Config:
    """Build a Config from ``key=value`` override strings, the programmatic
    equivalent of the reference's ``hydra.compose`` (reference:
    inference.py:44-47). ``task=<preset>`` selects a YAML preset; dotted
    ``task.foo=bar`` overrides leaf fields."""
    base = Config()
    task_name = None
    rest: List[Tuple[str, Any]] = []
    for ov in overrides:
        ov = ov.lstrip("+")
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        k, v = ov.split("=", 1)
        if k == "task":
            task_name = v
        else:
            rest.append((k, _coerce(v)))
    if task_name is not None:
        base.task = load_task_preset(task_name, conf_dir)
    for k, v in rest:
        _apply_to_dataclass(base, k, v)
    return base


def config_to_dict(cfg: Any) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: config_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(config_to_dict(x) for x in cfg)
    return cfg
