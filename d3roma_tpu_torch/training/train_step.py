"""The training step.

Port of `d3roma_tpu/training/train_step.py`: timesteps (uniform or
importance-sampled from the loss-aware sampler), randn or pyramid noise, the
forward process, channel-concat conditioning, the UNet forward, the loss of
each prediction type (epsilon / v_prediction / v_pred_depth / sample, l1 or
mse), the importance weighting, the optimizer chain and the loss-aware
sampler's update, all on the model's device with no read back to the host.

In the latent family the frozen VAE encodes the ground truth and the
conditions under no_grad; v_prediction's recon_mae diagnostic decodes
x_hat0 under no_grad too, while v_pred_depth's loss backpropagates through
the decoder (its weights stay frozen). `grad_norm` is the raw gradients'
global norm, before the clip.

The step's random draws go through `draws` (see `ops/noise.py`): the noise
first (one normal, or the pyramid's levels in order), then the timesteps,
then the RGB condition's noise, the order in which the JAX step splits its
key.

On a mesh (`parallel/`), a step is one data rank's share of the global
step, as the JAX step's under jit on a mesh: the draws are the whole global
batch's (the one-process run's), of which the rank keeps its rows; the loss
is the mean over the rank's rows, so the data ranks' gradients averaged
(`mean_gradients`, fp32 buckets) are the global mean's; the per-sample
losses and the timesteps are gathered along the data axis in rank order
before the loss-aware sampler's update, so every rank keeps the one-process
sampler state; and the metrics are the global batch's. Over the model axis
the sharded layers' collectives carry the gradients, and the chain's norm
and finiteness are the whole gradients' (`ChainOptimizer.norm_and_finite`).

Its phases are `torch.profiler.record_function` ranges
("train_step/vae_encode", "train_step/forward" with the loss,
"train_step/recon_decode", "train_step/backward", "train_step/optimizer",
"train_step/sampler"), which a profiler reads; the backward pass's kernels
are launched by autograd's device thread, outside the range that waits
for them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from d3roma_tpu_torch.models.vae import decode_latent, encode_disp_to_latent, encode_image_to_latent
from d3roma_tpu_torch.ops.noise import make_noise
from d3roma_tpu_torch.ops.resample import loss_aware_weights, sample_timesteps, update_loss_aware
from d3roma_tpu_torch.ops.schedules import ScheduleTables, add_noise, extract, get_velocity
from d3roma_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    all_reduce,
    mean_gradients,
)
from d3roma_tpu_torch.pipelines.sampling import build_cond_concat
from d3roma_tpu_torch.training.state import ChainOptimizer, TrainState


def make_train_step(
    config,
    unet: torch.nn.Module,
    optimizer: ChainOptimizer,
    tables: ScheduleTables,
    vae: Optional[torch.nn.Module] = None,
    text_embed: Optional[torch.Tensor] = None,
    t_sampler: Optional[str] = None,  # None -> config.timestep_sampler
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Returns step_fn(state, batch, draws) -> metrics (device tensors:
    loss, grad_norm, t_mean, recon_mae for the v-prediction types,
    per_sample_loss [B], timesteps [B]); it updates `state` in place.

    batch: the device_preprocess output dict (normalized_disp, sim_disp,
    normalized_rgb, left_image, right_image, mask, ...), channel-last; on a
    mesh of several data ranks, this rank's rows of the global batch (the
    metrics are the global batch's: B its rows)."""
    ldm = config.ldm
    loss_kind = config.loss_type
    pred_type = config.prediction_type
    cond_channels = config.cond_channels
    if t_sampler is None:
        t_sampler = getattr(config, "timestep_sampler", "uniform")
    if t_sampler not in ("uniform", "loss-second-moment"):
        raise ValueError(f"unknown timestep_sampler {t_sampler!r}")
    if loss_kind not in ("l1", "mse"):
        raise ValueError(f"loss type {loss_kind} not supported")
    if pred_type not in ("epsilon", "v_prediction", "v_pred_depth", "sample"):
        raise NotImplementedError(pred_type)
    if pred_type == "v_pred_depth" and not ldm:
        raise ValueError("v_pred_depth decodes x_hat0 through the VAE: latent family only")
    params = list(optimizer.params)
    dp = 1 if mesh is None else mesh.axis_sizes.get(DATA_AXIS, 1)
    rank_rows = 0 if dp == 1 else mesh.coord(DATA_AXIS)

    def rows(x: torch.Tensor, bs: int) -> torch.Tensor:
        """This data rank's rows of a draw for the global batch."""
        return x if dp == 1 else x[rank_rows * bs:(rank_rows + 1) * bs]

    def elementwise_loss(a, b):
        return torch.abs(a - b) if loss_kind == "l1" else (a - b) ** 2

    def forward_loss(inputs, noisy, noise, x_clean, t, weights, mask, normalized_disp, bs):
        """The UNet forward and the loss: (loss, per-sample loss, metrics)."""
        if ldm:
            ctx = text_embed.expand((bs,) + tuple(text_embed.shape[1:]))
            model_output = unet(inputs, t, ctx)
        else:
            model_output = unet(inputs, t)

        metrics = {}
        if pred_type == "epsilon":
            if ldm:
                network_loss = elementwise_loss(model_output, noise)
            else:
                network_loss = elementwise_loss(model_output * mask, noise * mask)
        elif pred_type == "v_prediction":
            v = get_velocity(tables, x_clean, noise, t)
            network_loss = elementwise_loss(model_output, v)
            with torch.no_grad(), record_function("train_step/recon_decode"):
                ab = extract(tables.alphas_cumprod, t, noisy.ndim)
                x0_hat_latent = torch.sqrt(ab) * noisy - torch.sqrt(1 - ab) * model_output
                x0_hat = decode_latent(vae, x0_hat_latent) if ldm else x0_hat_latent
                metrics["recon_mae"] = torch.mean(
                    torch.abs(torch.clamp(x0_hat, -1, 1) - normalized_disp))
        elif pred_type == "v_pred_depth":
            ab = extract(tables.alphas_cumprod, t, noisy.ndim)
            x0_hat_latent = torch.sqrt(ab) * noisy - torch.sqrt(1 - ab) * model_output
            x0_hat = decode_latent(vae, x0_hat_latent)
            network_loss = elementwise_loss(x0_hat * mask, normalized_disp * mask)
            metrics["recon_mae"] = torch.mean(
                torch.abs(torch.clamp(x0_hat.detach(), -1, 1) - normalized_disp))
        else:  # "sample": per-channel weighted masked loss
            channel_weights = (1.0, 1.0, 1.0)
            network_loss = 0.0
            for c in range(config.depth_channels):
                network_loss = network_loss + elementwise_loss(
                    model_output[..., c:c + 1] * mask,
                    normalized_disp[..., c:c + 1] * mask,
                ) * channel_weights[min(c, 2)]
            network_loss = network_loss / config.depth_channels

        loss = torch.mean(network_loss * weights.reshape(-1, 1, 1, 1))
        per_sample = torch.mean(network_loss.detach().reshape(bs, -1), dim=1)
        return loss, per_sample, metrics

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        normalized_disp = batch["normalized_disp"]
        mask = batch["mask"]

        # clip GT into the sample range, masking clipped pixels
        if config.clip_sample:
            r = config.clip_sample_range
            clipped = torch.clamp(normalized_disp, -r, r)
            mask = mask * (torch.abs(clipped) < r).to(mask.dtype)
            normalized_disp = clipped

        if ldm:
            with torch.no_grad(), record_function("train_step/vae_encode"):
                x_clean = encode_disp_to_latent(vae, normalized_disp)
                cond_sim = encode_disp_to_latent(vae, batch["sim_disp"])
                cond_rgb = (encode_image_to_latent(vae, batch["normalized_rgb"])
                            if "rgb" in cond_channels else None)
                cond_left = (encode_image_to_latent(vae, batch["left_image"])
                             if "left" in cond_channels else None)
                cond_right = (encode_image_to_latent(vae, batch["right_image"])
                              if "right" in cond_channels else None)
        else:
            x_clean = normalized_disp
            cond_sim = batch["sim_disp"]
            cond_rgb = batch["normalized_rgb"] if "rgb" in cond_channels else None
            cond_left = batch["left_image"] if "left" in cond_channels else None
            cond_right = batch["right_image"] if "right" in cond_channels else None

        bs = x_clean.shape[0]
        gb = bs * dp  # the global batch, whose draws every data rank makes
        noise = rows(make_noise(draws, (gb,) + tuple(x_clean.shape[1:]), config.noise_strategy,
                                x_clean.dtype), bs)

        if t_sampler == "uniform":
            t = rows(draws.randint(0, config.num_train_timesteps, gb), bs)
            weights = torch.ones((bs,), dtype=torch.float32, device=x_clean.device)
        else:
            t, weights = (rows(a, bs) for a in sample_timesteps(
                draws, loss_aware_weights(state.sampler_state), gb))

        if cond_rgb is not None and config.noise_rgb:
            rgb_noise = rows(draws.normal((gb,) + tuple(cond_rgb.shape[1:]), cond_rgb.dtype), bs)
            noisy_rgb = add_noise(tables, cond_rgb, rgb_noise, t)
            cond_rgb = cond_rgb * 0.5 + noisy_rgb * 0.5

        noisy = add_noise(tables, x_clean, noise, t)
        conds = build_cond_concat(cond_channels, cond_rgb, cond_left, cond_right, cond_sim)
        inputs = torch.cat([noisy, conds], dim=-1)
        with record_function("train_step/forward"):
            loss, per_sample, metrics = forward_loss(inputs, noisy, noise, x_clean, t, weights,
                                                     mask, normalized_disp, bs)

        with record_function("train_step/backward"):
            grads = torch.autograd.grad(loss, params)
        with record_function("train_step/optimizer"):
            if dp > 1:
                grads = mean_gradients(grads, mesh, DATA_AXIS)
            grad_norm, isfinite = optimizer.norm_and_finite(grads)
            optimizer.step(grads, grad_norm, isfinite)
        del grads
        loss = loss.detach()
        if dp > 1:
            # the global batch's: its per-sample losses and timesteps in rank
            # order, the means over the data ranks' equal shares of rows
            gathered = all_gather_cat(torch.stack([t.to(torch.float32), per_sample], 1), mesh,
                                      DATA_AXIS, 0)
            t, per_sample = gathered[:, 0].to(t.dtype), gathered[:, 1]
            means = torch.stack([loss] + ([metrics["recon_mae"]] if "recon_mae" in metrics
                                          else []))
            means = all_reduce(means, mesh, DATA_AXIS) / dp
            loss = means[0]
            if "recon_mae" in metrics:
                metrics["recon_mae"] = means[1]
        with record_function("train_step/sampler"):
            state.sampler_state = update_loss_aware(state.sampler_state, t, per_sample)
            state.step += 1

        out = {"loss": loss, "grad_norm": grad_norm, "t_mean": torch.mean(t.to(torch.float32))}
        if "recon_mae" in metrics:
            out["recon_mae"] = metrics["recon_mae"]
        out["per_sample_loss"] = per_sample
        out["timesteps"] = t
        return out

    return step_fn
