"""Evaluation: batch-level denoise + metric computation, quadrant tiling.

Port of `d3roma_tpu/evaluation/eval_loop.py` (reference: evaluate.py:28-297,
355-427): `eval_batch` pads the conditions, runs R inference rounds,
denormalizes (SSI LSQ/RANSAC through the Normalizer), optionally ensembles,
and computes disparity/depth metrics, the multi-round sigma uncertainty and
the error map; `evaluate_dataset` drives a loader with the guidance-weight
sweep, the coarse-to-fine 4-quadrant tiling, anomaly-aware running averages
and the artifacts.

Randomness. The JAX loop derives every key from one: batch i's
`fold_in(key, i)`, round r's `fold_in(batch key, r)`, the SSI RANSAC's
`fold_in(batch key, 999)`; each guidance weight and each quadrant reuses
the batch key. Here one seeded `torch.Generator` plays the root key:
batch i draws one seed from it, in batch order, and every eval_batch of
that batch (each weight, each quadrant) gets a fresh generator on the
pipeline's device seeded with it, which its rounds draw from in order and
the SSI RANSAC after them. A torch generator draws other noise than JAX's
keys, so the two packages' metrics agree only when a test replays the JAX
noise through the pipeline (`x_init` / `latents` and `step_noise`).

With guidance enabled (a weight of `flow_guidance_weights` above 0), the
latent pipeline takes the padded raw disparity and `denormer`, the
config's denormalization against it (RANSAC seeded 0 a call, as the JAX
package's PRNGKey(0)).

Under `guide_source="stereo-match"` the NCC block matcher
(`ops/stereo.py`) on the padded IR pair gives the guidance and SSI target.
`plot_intermediate_metrics` draws the epe and rel curves over the denoise
steps through `utils/viz.py`'s line charts.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3roma_tpu_torch.evaluation.averager import RunningAverager
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.ops.ensemble import ensemble_depths
from d3roma_tpu_torch.ops.metrics import compute_errors, metrics_to_dict
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.ops.padding import InputPadder
from d3roma_tpu_torch.ops.stereo import stereo_match

logger = logging.getLogger("d3roma_tpu_torch.eval")


def denormalize(config, pred_disps, raw_disp=None, mask=None,
                generator: Optional[torch.Generator] = None):
    """(reference: evaluate.py:59-64) pred_disps: [B,H,W,R]. SSI under
    safe_ssi runs RANSAC with subsets from `generator` (a generator seeded
    with 0 on the predictions' device when None, as the JAX package takes
    PRNGKey(0))."""
    norm = Normalizer.from_config(config)
    if norm.ssi and norm.safe_ssi and generator is None:
        generator = torch.Generator(device=pred_disps.device).manual_seed(0)
    return norm.denormalize(pred_disps, raw_disp, mask, generator=generator)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _cpu(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _protocol_dataset(config, dataset_name: Optional[str]) -> str:
    """The dataset whose eval protocol (clamp windows, artifact dumps)
    applies. The reference keys every dataset-specific branch on
    config.eval_dataset[0] even while iterating several datasets
    (reference: evaluate.py:126,246) — a bug when eval_dataset lists
    more than one. Callers that know the current dataset pass it;
    the [0] fallback preserves reference behavior otherwise."""
    if dataset_name is not None:
        return dataset_name
    return config.eval_dataset[0] if config.eval_dataset else ""


def _host_errors(config, gt, pred, mask, fxb):
    """compute_errors on the host (float32 CPU tensors); numpy (disp [B,5],
    depth [B,6]). The JAX loop moves these arrays back to its device for
    compute_errors; the port computes them where they already are, so that
    its float32 sums order the same way on the card as in the CPU tests."""
    md, me = compute_errors(_cpu(gt), _cpu(pred), config.prediction_space, _cpu(mask),
                            _cpu(_to_host(fxb)) if fxb is not None else None)
    return md.numpy(), me.numpy()


def eval_batch(
    config,
    pipeline,
    batch: Dict,
    generator: torch.Generator,
    dataset_name: Optional[str] = None,
) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray], Optional[np.ndarray], np.ndarray, object]:
    """batch: device_preprocess output (channel-last).

    Returns (pred_disp_unnorm [B,H,W], (metrics_disp, metrics_depth),
    uncertainty [B,H,W] | None, error_map [B,H,W], last pipeline output).
    The rounds draw from `generator` in order, then the SSI RANSAC.
    Reference: evaluate.py:66-148.
    """
    normalized_rgb = batch.get("normalized_rgb")
    left = batch.get("left_image")
    right = batch.get("right_image")
    sim_disp = batch.get("sim_disp")
    # guidance + SSI alignment target: the UNNORMALIZED raw disparity (the
    # JAX package's convention, eval_loop.py:78-84)
    raw_depth = batch.get("sim_disp_unnorm", batch.get("raw_depth"))
    raw_disp = batch["raw_disp"]
    mask = batch["mask"]
    fxb = batch.get("fxb")

    ref_img = normalized_rgb if normalized_rgb is not None else left
    padder = InputPadder(ref_img.shape, divis_by=config.divis_by)
    normalized_rgb, left, right, sim_disp, raw_depth_p = padder.pad(
        normalized_rgb, left, right, sim_disp, raw_depth
    )

    # guide-source selection (reference: evaluate.py:171-182): the block
    # matcher on the IR pair replaces the raw guidance target
    if (config.guide_source == "stereo-match" and left is not None
            and right is not None):
        scale = left.shape[2] / 640.0
        fxb_val = float(_to_host(fxb).reshape(-1)[0]) if fxb is not None else 24.0
        sm = stereo_match(
            (left + 1.0) / 2.0, (right + 1.0) / 2.0, fxb_val,
            min_disp=max(1, int(10 * scale)), max_disp=max(8, int(110 * scale)),
        )
        # the target is the raw *disparity* where the LRC kept it, metric
        # depth only for depth-space models
        disp = torch.where(sm.valid, sm.disp, torch.zeros_like(sm.disp))
        if config.prediction_space == "depth":
            raw_depth_p = torch.where(disp > 0, fxb_val / torch.clamp(disp, min=1e-6),
                                      torch.zeros_like(disp))[..., None]
        else:
            raw_depth_p = disp[..., None]

    def denormer(x):
        # SSI re-alignment inside the guidance loop aligns against the raw
        # target over its validity mask
        return denormalize(config, x, raw_depth_p, (raw_depth_p > 0))

    rounds = []
    out = None
    for _ in range(config.num_inference_rounds):
        kwargs = dict(
            num_inference_steps=config.num_inference_timesteps,
            num_intermediate_images=config.num_intermediate_images,
            cond_channels=config.cond_channels,
            rgb_images=normalized_rgb,
            left_images=left,
            right_images=right,
            sim_disp=sim_disp,
            add_noise_rgb=config.noise_rgb,
            generator=generator,
        )
        if hasattr(pipeline, "vae"):  # latent pipeline
            guidance = getattr(pipeline, "guidance", None)
            if guidance is not None and guidance.enabled:
                kwargs["raw_depth"] = raw_depth_p
                kwargs["denormer"] = denormer
        else:
            kwargs["depth_channels"] = config.depth_channels
            # sensor-validity mask for pixel imputation guidance
            if raw_depth_p is not None:
                kwargs["raw_mask"] = raw_depth_p > 0
        out = pipeline(**kwargs)
        rounds.append(padder.unpad(out.images).float())

    if out is not None and getattr(out, "intermediates", None) is not None:
        # intermediates [S,B,Hp,Wp,C] leave eval_batch unpadded like images
        inter = out.intermediates
        S = inter.shape[0]
        inter = padder.unpad(inter.reshape((S * inter.shape[1],) + tuple(inter.shape[2:])))
        out = out._replace(intermediates=inter.reshape((S, -1) + tuple(inter.shape[1:])))

    pred = torch.cat(rounds, dim=-1)  # [B,H,W,R]

    if config.ensemble:
        aligned = [ensemble_depths(pred[i].movedim(-1, 0))[0] for i in range(pred.shape[0])]
        pred = torch.stack(aligned)[..., None]

    pred_unnorm = denormalize(config, pred, raw_disp.to(pred.device), mask.to(pred.device),
                              generator=generator)
    gt = _to_host(raw_disp[..., 0])
    pred_mean = _to_host(torch.mean(pred_unnorm, dim=-1))

    if _protocol_dataset(config, dataset_name) == "SceneFlow":
        # SceneFlow disparity clamp window (reference: evaluate.py:126-131)
        scale = 960.0 / float(config.camera_resolution.split("x")[0])
        lo, hi = 0.5 / scale, 192.0 / scale
        m = (gt >= lo) & (gt < hi)
        pred_mean = np.clip(pred_mean, lo, hi)
    else:
        m = _to_host(mask[..., 0]).astype(bool)

    metrics = _host_errors(config, gt, pred_mean, m, fxb)

    if pred.shape[-1] > 1:
        # std of the NORMALIZED rounds, matching the reference
        # (evaluate.py:141-142 takes std before denormalization)
        unc = np.zeros_like(gt)
        unc[m] = _to_host(torch.std(pred, dim=-1, unbiased=False))[m]
    else:
        unc = None

    err = np.zeros_like(gt)
    err[m] = np.abs(gt[m] - pred_mean[m])
    return pred_mean, metrics, unc, err, out


def quadrants(H: int, W: int):
    """The 4 half-resolution tile slices for coarse_to_fine. At the
    reference's 540x960 protocol resolution these are exactly its
    hard-coded 270x480 tiles (evaluate.py:362-410)."""
    h2, w2 = H // 2, W // 2
    return [
        (slice(0, h2), slice(0, w2)),
        (slice(h2, None), slice(0, w2)),
        (slice(0, h2), slice(w2, None)),
        (slice(h2, None), slice(w2, None)),
    ]


_SLICED_KEYS = ("raw_disp", "normalized_disp", "sim_disp", "sim_mask",
                "sim_disp_unnorm", "left_image", "right_image",
                "normalized_rgb", "mask", "raw_depth", "depth")


def _pipelines_per_weight(config, pipeline, guidance_weights=None):
    """One pipeline object per guidance weight, sharing the models."""
    weights = [float(w) for w in (guidance_weights or config.flow_guidance_weights or [0.0])]
    guidance = getattr(pipeline, "guidance", None)
    current = guidance.flow_guidance_weight if guidance is not None else 0.0
    pipes = {}
    for w in weights:
        if hasattr(pipeline, "guidance") and w != current:
            base = guidance if guidance is not None else FlowGuidance()
            pipes[w] = dataclasses.replace(
                pipeline, guidance=dataclasses.replace(base, flow_guidance_weight=w))
        else:
            pipes[w] = pipeline
    return pipes


def _generator(seed: int, pipeline) -> torch.Generator:
    return torch.Generator(device=pipeline.device).manual_seed(seed)


def _batch_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (), generator=generator))


def eval_sliced_batch(config, pipeline, batch, generator, guidance_weights=None):
    """Sweep over flow_guidance_weights for one batch, returning
    {weight: eval_batch result} (reference: evaluate.py:188-194); every
    weight runs from the same seed, drawn from `generator`."""
    seed = _batch_seed(generator)
    pipes = _pipelines_per_weight(config, pipeline, guidance_weights)
    return {w: eval_batch(config, p, batch, _generator(seed, p)) for w, p in pipes.items()}


def evaluate_dataset(
    config,
    pipeline,
    loader,
    generator: torch.Generator,
    eval_output_dir: Optional[str] = None,
    preprocess=None,
    max_batches: Optional[int] = None,
    write_artifacts: bool = False,
    dataset_name: Optional[str] = None,
    gather_rows=None,
):
    """Loop a val loader; returns (metrics dict, RunningAverager).

    Sweeps config.flow_guidance_weights per batch with per-weight metric
    tracking (reference: evaluate.py:188-194); the returned dict is the LAST
    weight's aggregate plus a "per_weight" sub-dict when sweeping. Also
    handles coarse_to_fine quadrant tiling — metrics there are computed on
    the REASSEMBLED full-resolution prediction, not averaged per quadrant.
    Batch i draws its seed from `generator` (module docstring).
    `gather_rows(a)`, given by a data-parallel run, returns the rows of
    every data rank's array `a` in rank order: each batch's per-sample
    metrics and `sample_valid` go through it, so every rank averages the
    whole batch's real samples, in the order a one-process run takes them.

    Reference: evaluate.py:340-427 and distributed_evaluate.py:109-174.
    """
    pipes = _pipelines_per_weight(config, pipeline)
    weights = list(pipes.keys())
    stats = {w: RunningAverager(detect_anomaly={"epe": 10.0}) for w in weights}
    acc = {w: ([], []) for w in weights}  # (disp rows, depth rows)
    limit = max_batches if max_batches is not None else config.eval_num_batch

    def run_one(pipe, batch, seed):
        if config.coarse_to_fine:
            B, H, W = batch["raw_disp"].shape[:3]
            pred = np.zeros((B, H, W), np.float32)
            for (ys, xs) in quadrants(H, W):
                mini = {
                    k: (v[:, ys, xs] if k in _SLICED_KEYS and hasattr(v, "ndim") and v.ndim == 4
                        else v)
                    for k, v in batch.items()
                }
                p_mini, _, _, _, _ = eval_batch(config, pipe, mini, _generator(seed, pipe),
                                                dataset_name=dataset_name)
                pred[:, ys, xs] = p_mini
            gt = _to_host(batch["raw_disp"][..., 0])
            m = _to_host(batch["mask"][..., 0]).astype(bool)
            md, me = _host_errors(config, gt, pred, m, batch.get("fxb"))
            return pred, (md, me), None, None, None
        return eval_batch(config, pipe, batch, _generator(seed, pipe), dataset_name=dataset_name)

    for i, raw_batch in enumerate(loader):
        if limit and limit > 0 and i >= limit:
            break
        batch = preprocess(raw_batch) if preprocess is not None else raw_batch
        seed = _batch_seed(generator)

        # Padded-tail duplicates (marked sample_valid=0) must not enter the
        # averages (distributed_evaluate.py:162-167).
        sv = batch.get("sample_valid")
        sv = _to_host(sv) if sv is not None else None

        if gather_rows is not None and sv is not None:
            sv = gather_rows(sv)
        for w in weights:
            pred, metrics, unc, err, out = run_one(pipes[w], batch, seed)
            md, me = metrics
            if gather_rows is not None:
                md, me = gather_rows(md), gather_rows(me)
            for b in range(md.shape[0]):
                if sv is not None and sv[b] == 0.0:
                    continue
                sample = dict(zip(["epe", "d1", "d2", "d3", "d5"], md[b]))
                sample.update(zip(["a1", "a2", "a3", "rmse", "rel", "mae"], me[b]))
                if stats[w].append(sample, index=(i, b)):
                    acc[w][0].append(md[b])
                    acc[w][1].append(me[b])
            if len(weights) > 1:
                logger.info(
                    "batch %d guidance_weight=%g epe=%.4f rel=%.4f",
                    i, w, float(np.mean(md[:, 0])), float(np.mean(me[:, 4])),
                )

        if write_artifacts and eval_output_dir:
            _write_artifacts(config, batch, i, pred, err, unc, out, eval_output_dir,
                             dataset_name)

    last_w = weights[-1]
    per_weight = {
        w: (metrics_to_dict(np.stack(d), np.stack(e)) if d else {})
        for w, (d, e) in acc.items()
    }
    for w in weights:
        if per_weight[w]:
            flat = {
                f"{grp}/{k}": round(float(v), 4)
                for grp, sub in per_weight[w].items()
                for k, v in sub.items()
            }
            logger.info("guidance_weight=%g aggregate: %s", w, flat)
    result = dict(per_weight[last_w])
    if len(weights) > 1 and result:
        result["per_weight"] = per_weight
    return result, stats[last_w]


def _write_artifacts(config, batch, i, pred, err, unc, out, eval_output_dir, dataset_name):
    """One batch's artifacts: the JAX loop's files and names
    (eval_loop.py:320-400), the figures as colour-mapped pixels
    (utils/viz.py)."""
    from d3roma_tpu_torch.utils import viz

    os.makedirs(eval_output_dir, exist_ok=True)
    for b in range(pred.shape[0]):
        viz.save_colorized(os.path.join(eval_output_dir, f"idx{i}_{b}_pred_disp.png"), pred[b])
    if err is not None:
        viz.plot_error_map(
            _to_host(batch["raw_disp"][0, ..., 0]), pred[0], None,
            os.path.join(eval_output_dir, f"idx{i}_error.png"),
        )
    if unc is not None:
        viz.plot_uncertainties(unc[0], os.path.join(eval_output_dir, f"idx{i}_uncertainty.png"))
    if (config.plot_denoised_images and out is not None
            and getattr(out, "intermediates", None) is not None):
        # denoise-step grid (reference: evaluate.py:213-226)
        viz.plot_denoised_images(
            [_to_host(out.intermediates[s, 0, ..., 0]) for s in range(out.intermediates.shape[0])],
            os.path.join(eval_output_dir, f"idx{i}_denoised.png"),
        )
    if _protocol_dataset(config, dataset_name) == "HISS" and "fxb" in batch:
        # per-item predicted sim-depth EXR dump for the HISS protocol
        # (reference: evaluate.py:246-261)
        from d3roma_tpu_torch.utils.exr import write_exr

        fxb0 = float(_to_host(batch["fxb"])[0])
        for b in range(pred.shape[0]):
            depth_b = np.where(pred[b] > 0, fxb0 / np.maximum(pred[b], 1e-6), 0.0).astype(np.float32)
            write_exr(os.path.join(eval_output_dir, f"idx{i}_{b}_simDepthImage.exr"), depth_b)
    if (config.plot_intermediate_metrics and out is not None
            and getattr(out, "intermediates", None) is not None):
        inter = denormalize(
            config, out.intermediates[..., 0].movedim(0, -1).float(),
            batch["raw_disp"], batch["mask"],
        )  # [B,H,W,S]
        inter = inter.movedim(-1, 0)[..., None]
        imd, ime = evaluate_intermediate_metrics(
            config, batch.get("fxb"), inter, batch["raw_disp"], batch["mask"],
            dataset_name=dataset_name,
        )
        viz.plot_intermediate_metrics(
            {"epe": imd[0, :, 0], "rel": ime[0, :, 4]},
            os.path.join(eval_output_dir, f"idx{i}_intermediate_metrics.png"),
        )
    if config.write_pcd and "fxb" in batch:
        from d3roma_tpu_torch.utils.pointcloud import backproject_depth, write_ply

        fxb = float(_to_host(batch["fxb"])[0])
        K = _to_host(batch["K"][0]) if "K" in batch else np.eye(3)
        depth = np.where(pred[0] > 0, fxb / np.maximum(pred[0], 1e-6), 0)
        pts, _ = backproject_depth(depth.astype(np.float32), K)
        write_ply(os.path.join(eval_output_dir, f"idx{i}_pred.ply"), pts)


def evaluate_intermediate_metrics(
    config, fxb, intermediates: torch.Tensor, gt_disp: torch.Tensor,
    gt_mask: torch.Tensor, dataset_name: Optional[str] = None,
):
    """Metric curves over denoising steps (reference: evaluate.py:28-57).

    intermediates: [S, B, H, W, 1] *denormalized* per-step x_hat0 stacks;
    gt_disp/gt_mask: [B, H, W, 1]. Returns numpy (disp_metrics [B,S,5],
    depth_metrics [B,S,6]).
    """
    S, B, H, W, _ = intermediates.shape
    preds = intermediates[..., 0].movedim(0, 1).reshape(B * S, H, W).float()
    gts = torch.repeat_interleave(gt_disp[..., 0], S, dim=0).to(preds.device)
    masks = torch.repeat_interleave(gt_mask[..., 0] > 0, S, dim=0).to(preds.device)

    if _protocol_dataset(config, dataset_name) == "SceneFlow":
        scale = 960.0 / float(config.camera_resolution.split("x")[0])
        lo, hi = 0.5 / scale, 192.0 / scale
        masks = masks & (preds >= lo) & (preds < hi)
        preds = torch.clamp(preds, lo, hi)
    else:
        preds = torch.clamp(preds, min=0.25)  # prevent 0 disparities

    fxb_rep = torch.repeat_interleave(fxb, S, dim=0).to(preds.device) if fxb is not None else None
    md, me = compute_errors(gts, preds, config.prediction_space, masks, fxb_rep)
    return (_to_host(md).reshape(B, S, -1), _to_host(me).reshape(B, S, -1))
