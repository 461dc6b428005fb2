"""DeepCache accuracy sweep on a trained flagship checkpoint.

Port of the JAX package's `scripts/deepcache_accuracy.py`, with the
capstone recipe that trains the checkpoint (`_scratch/capstone_ldm.py`).
It measures the end-metric drift of DeepCache (deep-trunk reuse across
denoise steps) and of the shipped static int8 path against the exact
bf16 run, on procedural HISS frames (the repository generates them; no
real dataset is needed). The checkpoint is weakly trained, so absolute
metrics are poor; the drifts against the exact run are the signal.

    python -m d3roma_tpu_torch.deepcache_accuracy data  [--run DIR]
    python -m d3roma_tpu_torch.deepcache_accuracy train [--run DIR] [--steps 1520]
    python -m d3roma_tpu_torch.deepcache_accuracy sweep [--run DIR] [--ks 1,2,3,5]
        [--modes bf16,int8] [--frames 64] [--batch 4] [--seed 1234] [--out FILE]
    python -m d3roma_tpu_torch.deepcache_accuracy ceiling [--run DIR] [--frames 64]
        [--batch 4] [--out FILE]

`--device` names the torch device (default: cuda). Everything lives under
`--run` (default `capstone_ldm`, relative to the working directory):
`datasets/HISS` (the frames), `run/` (the training output,
`run/checkpoints/last` the checkpoint the sweep reads), one file per row
(`dc_row_<mode>_<cfg>.json`, `..._s<seed>.json` under another `--seed`, so a
cut sweep resumes from the rows it has; a row file of another checkpoint
step is evaluated again), the calibrated scales
(`dc_act_scales_step<N>_b<batch>_k<cfg>.json`) and the VAE ceiling
(`dc_vae_ceiling_f<frames>_b<batch>.json`).

- `data`: 64 train frames (seed 11) and 8 val frames (seed 97) at 360x640;
- `train`: the capstone recipe through `training.train(max_steps=N)`:
  `task=train_ldm_mixed_rgb+raw`, HISS oversampled 16x, batch 8, lr 1e-4,
  no warmup, bf16 compute, Adafactor, one in-training eval at step N. It
  resumes from `run/checkpoints/last` when one is there;
- `sweep`: the rows `<mode>:<cfg>` for every mode and config (bf16 rows
  skip the int8-only levers), each on its own copy of the loaded
  pipeline (the port's pipeline methods work in place), each evaluated from
  a generator seeded with `--seed` (1234, the JAX sweep's), then the table
  at `--out` (default `docs/deepcache_accuracy_torch.json` of the
  repository) with the VAE ceiling;
- `ceiling`: the VAE ceiling alone, added to the table at `--out`. It
  reads no checkpoint: the frozen VAE is drawn from the training's seed.

The VAE ceiling is the rows' metrics for the frozen VAE's round trip of
the ground truth, decode(encode(disparity)), through the same eval: the
score of a UNet whose every prediction were the ground truth's exact
latent, which training drives the rows toward. With a VAE that inverts its
encode it is the best a row can reach; the capstone's random frozen VAE
does not, and rows can score on either side of it.

A config is `<schedule>[d<depth>][q<pct>][m<margin>][p<kind>]` (`parse_cfg`):
schedule a uniform interval or an F/S pattern, d the shallow pass's depth,
q the activation-scale percentile clipping, m the PTQ margin, p a layer
class (dot, conv, attn, geglu) run in float at replay. Two modes: "bf16",
`half_precision()` alone (isolates the caching approximation), and "int8",
`fast_inference("throughput")` (calibrated static int8 in the UNet and the
VAE, the whole-row int8 attention, the fused int8 GEGLU), calibrated on the
first eval batch along the row's schedule. Scales are cached per
(checkpoint step, batch, cfg); a pinned config reuses its unpinned
config's capture.

Differences from the JAX script, none of which changes a row's numerics
but the pinned rows': the pins are traced at the eval's padded shape
(`eval_shape`), not a fixed 360x640; a pin kind that selects no call in a
replay table raises `EmptyPins` (the JAX `kind_pins` returns the empty
list, and its row equals the unpinned one), and the sweep lists that row
under "refused" in the table; all rows run in one process (the JAX
script's process per row group guarded its host memory).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import os
import re
import subprocess
import sys
import time
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("d3roma_tpu_torch.deepcache_accuracy")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "docs", "deepcache_accuracy_torch.json")
FRAME_HW = (360, 640)  # the capstone's procedural frames
TRAIN_FRAMES, TRAIN_SEED, VAL_FRAMES, VAL_SEED = 64, 11, 8, 97
CAPSTONE = ["task=train_ldm_mixed_rgb+raw", "task.train_dataset=[HISS]",
            # oversampled x16: a 1024-sample epoch, 128 steps at batch 8
            "task.dataset_weight=[16]", "task.eval_dataset=[HISS]",
            "task.train_batch_size=8", "task.mixed_precision=bf16",
            "task.optimizer=adafactor"]
EVAL_SEED = 1234  # every row's generator: the same noise draws per row
CALIB_SEED = 99
METS = (("disp", "epe"), ("depth", "rel"), ("depth", "rmse"), ("depth", "mae"))
NOTE = ("drift_pct = vs bf16 exact (mode=bf16,k=1) - for int8 rows this is the COMBINED "
        "quantization+caching deviation; drift_pct_vs_int8 isolates caching under "
        "quantization. Procedural HISS val frames on a checkpoint trained by "
        "`python -m d3roma_tpu_torch.deepcache_accuracy train` (no real dataset here).")


class _RoundTrip:
    """A stand-in pipeline for `evaluate_dataset`: its output is the VAE's
    round trip of the ground truth that `take` (in the preprocess) keeps
    of each batch, padded as the eval pads the conditions and clamped as a
    pipeline's output."""

    def __init__(self, pipe, divis_by: int):
        self.vae, self.device, self.divis_by, self.gt = pipe.vae, pipe.device, divis_by, None

    def take(self, batch: dict) -> dict:
        self.gt = batch["normalized_disp"]
        return batch

    def __call__(self, **_):
        import torch

        from d3roma_tpu_torch.models.vae import decode_latent, encode_disp_to_latent
        from d3roma_tpu_torch.ops.padding import InputPadder
        from d3roma_tpu_torch.pipelines.sampling import latent_decode_images

        (gt,) = InputPadder(self.gt.shape, divis_by=self.divis_by).pad(self.gt)
        with torch.no_grad():
            z = encode_disp_to_latent(self.vae, gt)
            return latent_decode_images(lambda x: decode_latent(self.vae, x), z[None])


class EmptyPins(ValueError):
    """A pin kind selected no call of a replay table."""


def parse_cfg(cfg: str) -> Tuple[object, int, Optional[float], Optional[float], Optional[str]]:
    """"2" | "2d2" | "FSFSFSFSFF" | "FSFSFSFSFFd2" | "1q0.999" | "1m1.0" |
    "1pattn" -> (schedule: int | str, depth, clip percentile, margin, pin
    kind), the JAX script's grammar."""
    m = re.fullmatch(r"([0-9]+|[FSfs]+)(?:d([0-9]+))?(?:q(0\.[0-9]+))?"
                     r"(?:m([0-9.]+))?(?:p(dot|conv|attn|geglu))?", cfg)
    if not m:
        raise ValueError(f"bad sweep config {cfg!r}")
    sched = int(m.group(1)) if m.group(1).isdigit() else m.group(1).upper()
    return (sched, int(m.group(2) or 1), float(m.group(3)) if m.group(3) else None,
            float(m.group(4)) if m.group(4) else None, m.group(5) or None)


def table_row(m: dict, baselines: Dict[str, dict]) -> dict:
    """A row of the table: each metric (4 places) and, against each
    baseline that is not `m` itself and not zero, its drift in percent (2
    places) under `<space>_<metric>_drift_pct<tag>`."""
    row = {}
    for space, met in METS:
        v = float(m[space][met])
        row[f"{space}_{met}"] = round(v, 4)
        for tag, base in baselines.items():
            b = float(base[space][met])
            if base is not m and b:
                row[f"{space}_{met}_drift_pct{tag}"] = round(100.0 * (v - b) / b, 2)
    return row


def wanted_rows(modes: Sequence[str], ks: Sequence[str]) -> List[Tuple[str, str]]:
    """(mode, cfg) of every row; clipping, margins and pins are int8 levers."""
    if "1" not in ks:
        raise ValueError("config 1 (exact) is the baseline: include it")
    if "bf16" not in modes or set(modes) - {"bf16", "int8"}:
        raise ValueError(f"modes must hold bf16 (the baseline) and may hold int8: {modes}")
    for k in ks:
        parse_cfg(k)
    return [(m, k) for m in modes for k in ks
            if not (m == "bf16" and parse_cfg(k)[2:] != (None, None, None))]


def build_doc(results: Dict[Tuple[str, str], dict], ks: Sequence[str],
              modes: Sequence[str], frames: int, steps: int,
              refused: Optional[Dict[str, str]] = None, ceiling: Optional[dict] = None,
              seed: int = EVAL_SEED) -> dict:
    """The table, in the JAX script's layout, from each row's metrics, plus
    the card (`device`), the refused rows, the VAE ceiling and, where it is
    not EVAL_SEED, the rows' seed."""
    exact = results[("bf16", "1")]
    devices = sorted({r.get("_device", "not recorded") for r in results.values()})
    doc = {"checkpoint_step": exact.get("_checkpoint_step"), "frames": frames, "steps": steps,
           "device": "; ".join(devices), "note": NOTE,
           "bf16": {k: table_row(results[("bf16", k)], {"": exact})
                    for k in ks if ("bf16", k) in results}}
    if "int8" in modes:
        base = results[("int8", "1")]
        doc["combined_int8"] = {k: table_row(results[("int8", k)],
                                             {"": exact, "_vs_int8": base})
                                for k in ks if ("int8", k) in results}
    if refused:
        doc["refused"] = dict(refused)
    if ceiling is not None:
        doc["vae_ceiling"] = table_row(ceiling, {})
    if seed != EVAL_SEED:
        doc["eval_seed"] = seed
    return doc


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's type."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


@contextlib.contextmanager
def _cwd(path: str):
    """The config's dataset roots are relative to the working directory."""
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _seed(base) -> int:
    seed = getattr(base, "seed", 0)
    return 0 if seed is None or seed < 0 else int(seed)


def data(run: str, val_frames: int = VAL_FRAMES) -> None:
    """The capstone's frames under run/datasets/HISS: 64 train frames, and
    val frames up to `val_frames` (the same seed: a superset of fewer)."""
    import glob

    from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset

    root = os.path.join(run, "datasets", "HISS")
    scene = SceneConfig(height=FRAME_HW[0], width=FRAME_HW[1])
    if not os.path.isdir(os.path.join(root, "train")):
        generate_dataset(root, TRAIN_FRAMES, "train", scene, seed=TRAIN_SEED)
    have = len(glob.glob(os.path.join(root, "val", "scene_0000", "*_depth.exr")))
    if have < val_frames:
        logger.info("val split %d -> %d frames", have, val_frames)
        generate_dataset(root, val_frames, "val", scene, seed=VAL_SEED)


def train(run: str, steps: int, device=None) -> dict:
    """The capstone recipe to global step `steps`, resuming from
    run/run/checkpoints/last. Returns the counter's state."""
    from d3roma_tpu_torch.config import compose
    from d3roma_tpu_torch.training import latest_checkpoint
    from d3roma_tpu_torch.training import train as train_loop

    data(run)
    out = os.path.join(os.path.abspath(run), "run")
    last = latest_checkpoint(out)
    if last:
        with open(os.path.join(last, "counter.json")) as f:
            counter = json.load(f)
        if counter["global_step"] >= steps:
            logger.info("checkpoint at step %d already", counter["global_step"])
            return counter
    base = compose(CAPSTONE + ["task.eval_batch_size=4", "task.eval_num_batch=2",
                               "task.gradient_accumulation_steps=1",
                               f"task.val_every_global_steps={steps}",
                               "task.learning_rate=1e-4", "task.lr_warmup_steps=0",
                               "task.num_epochs=1000"])
    base.task.output_dir = out
    os.makedirs(out, exist_ok=True)
    log = logging.FileHandler(os.path.join(out, "train.log"))
    log.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logging.getLogger().addHandler(log)
    try:
        with _cwd(run):
            _, counter, _ = train_loop(base.task, base, out, max_steps=steps, device=device)
    finally:
        logging.getLogger().removeHandler(log)
    return counter.state_dict()


def eval_shape(config) -> Tuple[int, int]:
    """The eval's padded height and width (the preset's image size, padded
    to divis_by)."""
    from d3roma_tpu_torch.ops.padding import InputPadder

    return InputPadder(config.image_hw, divis_by=config.divis_by).padded_size


def _evaluate(config, pipe, loader, preprocess, seed=EVAL_SEED, max_batches=None):
    import torch

    from d3roma_tpu_torch.evaluation import evaluate_dataset

    m, _ = evaluate_dataset(config, pipe, loader, torch.Generator().manual_seed(seed),
                            preprocess=preprocess,
                            max_batches=max_batches or config.eval_num_batch,
                            dataset_name="HISS")
    return m


def load_unet(ckpt: str, unet) -> int:
    """The trained UNet parameters of checkpoint `ckpt` (its `state.pt`,
    whatever optimizer wrote it) into `unet`; returns the global step."""
    import torch

    from d3roma_tpu_torch.training.checkpoint import STATE_FILE

    path = os.path.join(ckpt, STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {ckpt}: run the train subcommand")
    # mapped: only the parameters are read, not the optimizer's moments
    params = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["params"]
    unet.load_state_dict(params, strict=True)
    with open(os.path.join(ckpt, "counter.json")) as f:
        return int(json.load(f)["global_step"])


class Sweep:
    """The rows of one checkpoint: `base` the loaded pipeline (bf16,
    remat off), never changed; each row runs on its own copy."""

    def __init__(self, run: str, config, base, loader, checkpoint_step: Optional[int],
                 batch: int, seed: int = EVAL_SEED):
        from d3roma_tpu_torch.data import preprocess_eval
        from d3roma_tpu_torch.ops.normalizer import Normalizer

        self.run, self.config, self.base, self.loader = run, config, base, loader
        self.step = None if checkpoint_step is None else int(checkpoint_step)
        self.batch, self.seed = int(batch), int(seed)
        self.device = base.device
        self.preprocess = partial(preprocess_eval, config=config,
                                  normalizer=Normalizer.from_config(config), device=self.device)

    @classmethod
    def from_checkpoint(cls, run: str, frames: int, batch: int, device=None,
                        seed: int = EVAL_SEED, load: bool = True) -> "Sweep":
        """The capstone's models at the checkpoint run/run/checkpoints/last
        (with `load` False, the UNet untrained and no step: for the VAE
        ceiling alone), the eval of `frames` val frames at `batch`, the rows
        drawn from `seed`."""
        from d3roma_tpu_torch.config import compose
        from d3roma_tpu_torch.data import val_loaders
        from d3roma_tpu_torch.device import resolve_device
        from d3roma_tpu_torch.training import build_models, create_pipeline

        device = resolve_device(device)
        base = compose(CAPSTONE + [f"task.eval_batch_size={batch}",
                                   f"task.eval_num_batch={max(1, frames // batch)}"])
        config = base.task
        # the training's models (its seed draws the frozen VAE), then the
        # trained UNet
        models = build_models(config, _seed(base), device)
        step = None
        if load:
            step = load_unet(os.path.join(run, "run", "checkpoints", "last"), models["unet"])
            logger.info("loaded checkpoint @ step %d", step)
        pipe = create_pipeline(config, models).half_precision()
        # remat is a training lever: at inference it only recomputes
        pipe.unet.remat = False
        with _cwd(run):
            loader = val_loaders(config)[0]
        return cls(run, config, pipe, loader, step, batch, seed)

    def _scales_path(self, cfg: str) -> str:
        return os.path.join(self.run, f"dc_act_scales_step{self.step}_b{self.batch}"
                                      f"_k{cfg.replace('.', 'p')}.json")

    def pins(self, pipe, kind: str) -> Dict[str, List[int]]:
        """kind_pins at the eval's padded shape; raises EmptyPins where the
        kind selects no call of a table."""
        h, w = eval_shape(self.config)
        pins = pipe.kind_pins((kind,), batch=self.batch, height=h, width=w)
        empty = [t for t, idx in pins.items() if not idx]
        if empty:
            raise EmptyPins(f"pin kind {kind!r} selects no call of {empty} at batch "
                            f"{self.batch} x {h}x{w}: the row would replay the unpinned "
                            f"config's table")
        return pins

    def pipeline(self, mode: str, cfg: str):
        """A copy of the base pipeline configured for the row (mode, cfg);
        int8 rows calibrated on the first eval batch (or their cached
        scales)."""
        sched, depth, clip, margin, pin = parse_cfg(cfg)
        pipe = copy.deepcopy(self.base)
        if mode == "int8":
            pipe.fast_inference("throughput")
        elif mode != "bf16":
            raise ValueError(f"unknown mode {mode!r}")
        if isinstance(sched, str) or sched > 1 or depth != 1:
            pipe.deepcache(sched, depth=depth)
        if mode == "bf16":
            return pipe
        # a pin changes the replay only: the unpinned config's capture
        capture_cfg = (cfg[:cfg.rindex("p" + pin)] or "1") if pin else cfg
        cache = self._scales_path(capture_cfg)
        if margin is not None and clip is None and not os.path.exists(cache):
            # a margin ablation replays the matching q0.999 config's capture
            alt = self._scales_path(capture_cfg[:capture_cfg.index("m")] + "q0.999")
            cache = alt if os.path.exists(alt) else cache
        if os.path.exists(cache):
            with open(cache) as f:
                pipe.act_scales = json.load(f)
            logger.info("scales of %s loaded from %s", cfg, cache)
        else:
            import torch

            with _cwd(self.run):
                batch = self.preprocess(next(iter(self.loader)))
            t0 = time.perf_counter()
            pipe.calibrate(torch.Generator(device=self.device).manual_seed(CALIB_SEED),
                           [dict(rgb_images=batch["normalized_rgb"],
                                 sim_disp=batch["sim_disp"])],
                           cond_channels=self.config.cond_channels,
                           num_inference_steps=self.config.num_inference_timesteps,
                           quantiles=((clip,) if clip else ((0.999,) if margin else None)))
            with open(cache, "w") as f:
                json.dump(pipe.act_scales, f)
            logger.info("int8 %s calibration done in %.0fs -> %s", capture_cfg,
                        time.perf_counter() - t0, cache)
        if clip:
            pipe.with_act_clipping(percentile=clip)
        elif margin is not None:
            pipe.with_act_clipping(margin=margin)
        if pin:
            pipe.with_act_clipping(pins=self.pins(pipe, pin))
        return pipe

    def evaluate(self, pipe, seed: Optional[int] = None,
                 max_batches: Optional[int] = None) -> dict:
        """`evaluate_dataset` of `pipe` on the sweep's frames (the first
        `max_batches` batches, else all), its batches' noise drawn from a
        generator seeded with `seed` (default: the sweep's)."""
        seed = self.seed if seed is None else seed
        with _cwd(self.run):
            return _evaluate(self.config, pipe, self.loader, self.preprocess, seed, max_batches)

    def vae_ceiling(self) -> dict:
        """The VAE ceiling's metrics (module docstring), from its file when
        one is there, else evaluated (from EVAL_SEED whatever the rows'
        seed: it draws no noise, and one file serves every seed) and
        written."""
        import torch

        from d3roma_tpu_torch.evaluation import evaluate_dataset

        frames = self.batch * self.config.eval_num_batch
        path = os.path.join(self.run, f"dc_vae_ceiling_f{frames}_b{self.batch}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        trip = _RoundTrip(self.base, self.config.divis_by)
        with _cwd(self.run):
            m, _ = evaluate_dataset(self.config, trip, self.loader,
                                    torch.Generator().manual_seed(EVAL_SEED),
                                    preprocess=lambda b: trip.take(self.preprocess(b)),
                                    dataset_name="HISS")
        m = {s: {k: float(v) for k, v in d.items()} for s, d in m.items()}
        m.update(_device=device_label(self.device))
        with open(path, "w") as f:
            json.dump(m, f)
        logger.info("VAE ceiling: epe=%.4f absrel=%.4f", m["disp"]["epe"], m["depth"]["rel"])
        return m

    def row_path(self, mode: str, cfg: str) -> str:
        tag = "" if self.seed == EVAL_SEED else f"_s{self.seed}"
        return os.path.join(self.run, f"dc_row_{mode}_{cfg}{tag}.json")

    def row(self, mode: str, cfg: str) -> dict:
        """The row's metrics, from its file when one of this checkpoint step
        is there, else evaluated and written."""
        path = self.row_path(mode, cfg)
        if os.path.exists(path):
            with open(path) as f:
                m = json.load(f)
            if m.get("_checkpoint_step") == self.step:
                return m
            logger.info("%s: step %s, not the checkpoint's %s: evaluated again", path,
                        m.get("_checkpoint_step"), self.step)
        pipe = self.pipeline(mode, cfg)
        t0 = time.perf_counter()
        m = self.evaluate(pipe)
        seconds = time.perf_counter() - t0
        del pipe
        m = {s: {k: float(v) for k, v in d.items()} for s, d in m.items()}
        m.update(_checkpoint_step=self.step, _device=device_label(self.device),
                 _seconds=round(seconds, 1))
        with open(path, "w") as f:
            json.dump(m, f)
        logger.info("%s %s done in %.0fs: epe=%.4f absrel=%.4f", mode, cfg, seconds,
                    m["disp"]["epe"], m["depth"]["rel"])
        return m

    def table(self, ks: Sequence[str], modes: Sequence[str], frames: int) -> dict:
        """Every wanted row (a pin row whose kind selects no call is
        refused and listed), then the table."""
        results, refused = {}, {}
        for mode, k in wanted_rows(modes, ks):
            try:
                results[(mode, k)] = self.row(mode, k)
            except EmptyPins as e:
                logger.error("%s:%s refused: %s", mode, k, e)
                refused[f"{mode}:{k}"] = str(e)
        return build_doc(results, ks, modes, frames, self.config.num_inference_timesteps,
                         refused, self.vae_ceiling(), self.seed)


def sweep(run: str, ks: Sequence[str], modes: Sequence[str], frames: int, batch: int,
          out: str, device=None, seed: int = EVAL_SEED) -> dict:
    """Every row of `modes` x `ks` on run's checkpoint, drawn from `seed`,
    the table written to `out`."""
    wanted_rows(modes, ks)  # refuse a bad list before loading anything
    data(run, frames)
    doc = Sweep.from_checkpoint(run, frames, batch, device, seed).table(ks, modes, frames)
    _write(out, doc)
    return doc


def ceiling(run: str, frames: int, batch: int, out: str, device=None) -> dict:
    """The VAE ceiling on `frames` val frames at `batch`, added to the table
    at `out` (which must be of as many frames)."""
    with open(out) as f:
        doc = json.load(f)
    if doc["frames"] != frames:
        raise ValueError(f"{out} is a table of {doc['frames']} frames, not {frames}")
    data(run, frames)
    doc["vae_ceiling"] = table_row(
        Sweep.from_checkpoint(run, frames, batch, device, load=False).vae_ceiling(), {})
    _write(out, doc)
    return doc


def _write(out: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    logger.info("wrote %s", out)


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="python -m d3roma_tpu_torch.deepcache_accuracy")
    parser.add_argument("command", choices=("data", "train", "sweep", "ceiling"))
    parser.add_argument("--run", default="capstone_ldm", help="work directory")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--steps", type=int, default=1520, help="train: global steps")
    parser.add_argument("--ks", default="1,2,3,5", help="sweep: configs, comma-separated")
    parser.add_argument("--modes", default="bf16,int8", help="sweep: bf16 and/or int8")
    parser.add_argument("--frames", type=int, default=64, help="sweep: eval frames")
    parser.add_argument("--batch", type=int, default=4, help="sweep: eval batch")
    parser.add_argument("--seed", type=int, default=EVAL_SEED, help="sweep: the rows' seed")
    parser.add_argument("--out", default=DEFAULT_OUT, help="sweep, ceiling: the table's file")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    run = os.path.abspath(args.run)
    os.makedirs(run, exist_ok=True)
    if args.command == "data":
        data(run)
    elif args.command == "train":
        print(json.dumps(train(run, args.steps, args.device)), flush=True)
    elif args.command == "sweep":
        doc = sweep(run, args.ks.split(","), args.modes.split(","), args.frames, args.batch,
                    os.path.abspath(args.out), args.device, args.seed)
        print(json.dumps(doc), flush=True)
    else:
        doc = ceiling(run, args.frames, args.batch, os.path.abspath(args.out), args.device)
        print(json.dumps(doc["vae_ceiling"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
