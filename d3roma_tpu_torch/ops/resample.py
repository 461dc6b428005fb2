"""Importance sampling of diffusion timesteps, on the device.

Port of `d3roma_tpu/ops/resample.py`: the loss-second-moment sampler's state
is a pair of tensors updated inside the train step with no read back to
the host. `update_loss_aware` inserts the batch's (t, loss) pairs one after
another, as the JAX package's scan does, so two equal timesteps in one
batch both land in that timestep's history, in batch order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SamplerState(NamedTuple):
    """loss_history [T, H] (recent losses per timestep, fp32) and
    loss_counts [T] (valid entries per timestep, int32)."""

    loss_history: torch.Tensor
    loss_counts: torch.Tensor


def init_loss_aware_state(T: int, history_per_term: int = 10, device=None) -> SamplerState:
    return SamplerState(
        loss_history=torch.zeros((T, history_per_term), dtype=torch.float32, device=device),
        loss_counts=torch.zeros((T,), dtype=torch.int32, device=device),
    )


def loss_aware_weights(state: SamplerState, uniform_prob: float = 0.001) -> torch.Tensor:
    """sqrt(E[loss^2]) per timestep, mixed with a uniform floor; uniform until
    every timestep's history is full."""
    T, H = state.loss_history.shape
    warmed = torch.all(state.loss_counts == H)
    w = torch.sqrt(torch.mean(state.loss_history**2, dim=-1))
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    w = w * (1.0 - uniform_prob) + uniform_prob / T
    return torch.where(warmed, w, torch.full_like(w, 1.0 / T))


def update_loss_aware(state: SamplerState, ts: torch.Tensor,
                      losses: torch.Tensor) -> SamplerState:
    """Insert the (t, loss) pairs in batch order: append while a timestep's
    ring is not full, else shift out its oldest entry. Returns new tensors."""
    hist, counts = state.loss_history.clone(), state.loss_counts.clone()
    H = hist.shape[1]
    slots = torch.arange(H, device=hist.device)
    losses = losses.to(hist.dtype)
    for i in range(ts.shape[0]):
        t = ts[i].long().reshape(1)
        cnt = counts.index_select(0, t)  # [1]
        row = hist.index_select(0, t)  # [1, H]
        loss = losses[i].reshape(1, 1)
        full = cnt == H
        shifted = torch.cat([row[:, 1:], loss], dim=1)
        appended = torch.where(slots == cnt, loss, row)
        hist.index_copy_(0, t, torch.where(full, shifted, appended))
        counts.index_copy_(0, t, torch.where(full, cnt, cnt + 1))
    return SamplerState(hist, counts)


def sample_timesteps(draws, weights: torch.Tensor, batch_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sample timesteps: (t [B], importance weights [B]) with
    E[w * loss] unbiased."""
    T = weights.shape[0]
    p = weights / torch.sum(weights)
    t = draws.categorical(p, batch_size)
    w = 1.0 / (T * p[t])
    return t, w


def uniform_weights(T: int, device=None) -> torch.Tensor:
    return torch.ones((T,), dtype=torch.float32, device=device)


def snr_weights(tables) -> torch.Tensor:
    """SNR-proportional sampling weights."""
    ab = tables.alphas_cumprod
    return ab / (1.0 - ab)


def create_named_schedule_sampler(name: str, T: int, tables=None, device=None):
    """Name-based factory: (weights_fn, state or None); uniform and snr are
    stateless, the loss-aware sampler carries a SamplerState."""
    if name == "uniform":
        return (lambda state=None: uniform_weights(T, device)), None
    if name == "snr":
        assert tables is not None, "snr sampler needs schedule tables"
        w = snr_weights(tables)
        return (lambda state=None: w), None
    if name == "loss-second-moment":
        return loss_aware_weights, init_loss_aware_state(T, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
