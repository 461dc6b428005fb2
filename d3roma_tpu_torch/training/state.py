"""Train state, step counter, learning-rate schedules and the optimizer chain.

Port of `d3roma_tpu/training/state.py`. The JAX package's optimizer is the
optax chain

    apply_if_finite(MultiSteps(chain(clip_by_global_norm, adamw | adafactor)), 100)

(MultiSteps only with gradient accumulation, the clip only with a positive
`clip_grad_norm`). `ChainOptimizer` is that chain written out on torch
tensors, in the same order and arithmetic:

- the clip is optax's: a gradient is kept when its global norm is below
  `max_norm`, else scaled by `max_norm / norm` (`t / norm * max_norm`; not
  `clip_grad_norm_`'s division by `norm + 1e-6`);
- AdamW is optax's `adamw`: b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias corrections 1 - b^count, weight decay 1e-2 added to the Adam
  direction before the learning rate scales it;
- Adafactor is optax's `adafactor(multiply_by_parameter_scale=True,
  clipping_threshold=1.0)`: the factored second moment over the two
  largest axes of each parameter in the Flax layout (HWIO conv kernels,
  [in, out] dense kernels; a torch parameter is viewed in that layout),
  decay 1 - t^-0.8, eps 1e-30, the update's block-RMS clip at 1, the
  learning rate, the parameter's RMS (at least 1e-3), no momentum;
- MultiSteps averages the micro-gradients (Welford, acc + (g - acc) / (n + 1))
  and emits the inner update every k-th accepted micro step;
- apply_if_finite rejects a step whose gradients are not all finite: the
  parameters, the accumulator, the moments and the schedule's count stay as
  they were, until more than 100 steps in a row were rejected; then it
  accepts.

All of it runs on the parameters' device with `torch.where` selections, so
a step reads nothing back to the host.

Over a tensor-parallel state (`shard_`, called by `parallel/tensor.py::
shard_state_tp`) each rank holds its shards of the sharded parameters and
of their moments, and the chain sees whole parameters, as optax does under
GSPMD: the global norm sums the sharded leaves' squares over the model axis
and counts the replicated ones once, and every rank rejects a step that is
not finite on any rank (`norm_and_finite`, one collective); Adafactor
factors by the whole parameter's shape and takes its row and column means,
the update's block RMS and the parameter's RMS over the whole parameter.
AdamW is elementwise. `state_dict(whole=True)` gathers the one-process
layout. The schedules are pure functions of
the update count (`build_lr_schedule`), equal to optax's `join_schedules`
of linear warmup, cosine with hard restarts and linear decay, in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from d3roma_tpu_torch.ops.resample import SamplerState, init_loss_aware_state
from d3roma_tpu_torch.parallel.mesh import Mesh, all_reduce
from d3roma_tpu_torch.parallel.tensor import (
    MODEL_AXIS,
    TPShard,
    gather_params_tp,
    whole_tensors,
)

Schedule = Callable[[torch.Tensor], torch.Tensor]

# the chain's constants (the JAX package's build_optimizer)
MAX_CONSECUTIVE_ERRORS = 100
ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-2


# ---------------------------------------------------------------------- #
# schedules (optax's, on a 0-d int32 count)
# ---------------------------------------------------------------------- #


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor of x on like's device, filled there (a copy from
    the host would synchronize)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: _f32(init_value, count)

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float32)
        frac = 1.0 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: _f32(value, count)


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * cosine

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def build_lr_schedule(config, steps_per_epoch: int) -> Schedule:
    """The learning rate as a function of the optimizer-update count (not
    of micro-batches: under gradient accumulation the count advances once
    per accumulated update). lr_warmup_steps is in optimizer updates."""
    base = config.learning_rate
    warmup = config.lr_warmup_steps
    accum = max(1, config.gradient_accumulation_steps)
    total = max(1, config.num_epochs * steps_per_epoch // accum)
    kind = config.lr_scheduler or "constant"
    if kind == "constant":
        return join_schedules([linear_schedule(0.0, base, warmup), constant_schedule(base)],
                              [warmup])
    if kind == "cosine":
        # cosine with hard restarts, num_cycles cycles
        cycles = max(1, config.num_cycles)
        per = max(1, (total - warmup) // cycles)
        scheds = [linear_schedule(0.0, base, warmup)]
        bounds = [warmup]
        for i in range(cycles):
            scheds.append(cosine_decay_schedule(base, per))
            if i < cycles - 1:
                bounds.append(warmup + per * (i + 1))
        return join_schedules(scheds, bounds)
    if kind == "linear":
        return join_schedules([linear_schedule(0.0, base, warmup),
                               linear_schedule(base, 0.0, max(1, total - warmup))],
                              [warmup])
    raise ValueError(f"unknown lr_scheduler: {kind}")


# ---------------------------------------------------------------------- #
# the optimizer chain
# ---------------------------------------------------------------------- #


def flax_view(t: torch.Tensor) -> torch.Tensor:
    """A torch parameter (or its gradient) in the Flax layout, as a view:
    conv weights OIHW -> HWIO, dense weights [out, in] -> [in, out]."""
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    if t.ndim == 2:
        return t.t()
    return t


def flax_dim(ndim: int, dim: int) -> int:
    """Where torch dim `dim` of an `ndim`-dim tensor lands in `flax_view`."""
    if ndim == 4:
        return (3, 2, 0, 1)[dim]
    return 1 - dim if ndim == 2 else dim


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's choice: the two largest axes (second, largest), or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, optax.global_norm."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class ChainOptimizer:
    """The JAX package's optimizer chain over `params` (a list of tensors,
    updated in place by `step`). `kind` is "adamw" or "adafactor"."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Schedule, kind: str = "adamw",
                 clip_grad_norm: float = 0.0, accumulation: int = 1):
        if kind not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer: {kind!r}")
        self.params = list(params)
        self.schedule = schedule
        self.kind = kind
        self.clip = float(clip_grad_norm or 0.0)
        self.accumulation = max(1, int(accumulation))
        # set by shard_: the model axis's mesh and each parameter's TPShard
        self.mesh: Optional[Mesh] = None
        self.shards: list = [None] * len(self.params)
        # Adafactor's factoring, decided on each whole parameter's shape
        self.factored = [_factored_dims(tuple(flax_view(p).shape)) for p in self.params]
        dev = self.params[0].device

        def scalar(value, dtype=torch.int32):
            return torch.tensor(value, dtype=dtype, device=dev)

        st: Dict[str, object] = {
            "notfinite_count": scalar(0), "last_finite": scalar(True, torch.bool),
            "total_notfinite": scalar(0),
            # the inner chain's update count: the schedule's, Adam's and the
            # factored moments' (they advance together)
            "count": scalar(0),
        }
        if self.accumulation > 1:
            st["mini_step"] = scalar(0)
            st["gradient_step"] = scalar(0)
            st["acc"] = [torch.zeros_like(p) for p in self.params]
        if kind == "adamw":
            st["mu"] = [torch.zeros_like(p) for p in self.params]
            st["nu"] = [torch.zeros_like(p) for p in self.params]
        else:
            rows, cols, full = [], [], []
            for p, dims in zip(self.params, self.factored):
                fp = flax_view(p)
                one = torch.zeros((1,), dtype=p.dtype, device=dev)
                if dims is not None:
                    d1, d0 = dims
                    rows.append(torch.zeros([s for i, s in enumerate(fp.shape) if i != d0],
                                            dtype=p.dtype, device=dev))
                    cols.append(torch.zeros([s for i, s in enumerate(fp.shape) if i != d1],
                                            dtype=p.dtype, device=dev))
                    full.append(one)
                else:
                    rows.append(one)
                    cols.append(one.clone())
                    full.append(torch.zeros_like(fp))
            st["v_row"], st["v_col"], st["v"] = rows, cols, full
        self.state = st

    # ------------------------------------------------------------------ #
    # tensor parallelism
    # ------------------------------------------------------------------ #
    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_sizes.get(MODEL_AXIS, 1)

    def _moment_shard(self, key: str, i: int) -> Optional[TPShard]:
        """How parameter i's moment `key` is cut: as the parameter for the
        elementwise ones; Adafactor's along the parameter's sharded dim in
        their Flax-layout shapes, whole where the dim was averaged away."""
        sh = self.shards[i]
        if sh is None or key in ("mu", "nu", "acc"):
            return sh
        s, dims = flax_dim(self.params[i].ndim, sh.dim), self.factored[i]
        if key == "v":
            d = None if dims is not None else s
        elif dims is None:
            d = None
        else:
            gone = dims[1] if key == "v_row" else dims[0]
            d = None if s == gone else s - (s > gone)
        return None if d is None else TPShard(sh.mesh, d, sh.paired)

    @torch.no_grad()
    def shard_(self, mesh: Mesh, params: Sequence[torch.Tensor], shards: Sequence) -> None:
        """Take the sharded parameters `params` (in order; `shards[i]` the
        TPShard parameter i is cut by, or None) and cut the moments to this
        rank's shards, in place."""
        self.params, self.mesh, self.shards = list(params), mesh, list(shards)
        for key in ("mu", "nu", "acc", "v", "v_row", "v_col"):
            if key in self.state:
                self.state[key] = [
                    t if sh is None else sh.take(t).clone(memory_format=torch.contiguous_format)
                    for t, sh in ((t, self._moment_shard(key, i))
                                  for i, t in enumerate(self.state[key]))]

    def sharded_counts(self):
        """(sharded parameters, sharded optimizer tensors) this rank holds."""
        moments = sum(self._moment_shard(k, i) is not None for k, v in self.state.items()
                      if isinstance(v, list) for i in range(len(v)))
        return sum(sh is not None for sh in self.shards), moments

    def nbytes(self) -> int:
        """The bytes of the optimizer state this rank holds."""
        return sum(t.numel() * t.element_size() for v in self.state.values()
                   for t in (v if isinstance(v, list) else [v]))

    def _model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.mesh, MODEL_AXIS)

    def norm_and_finite(self, grads: Sequence[torch.Tensor]):
        """(the global norm of the whole gradients, whether all of them are
        finite), the same on every rank of the model axis."""
        if self.tp == 1:
            return global_norm(grads), torch.stack([torch.isfinite(g).all() for g in grads]).all()
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sharded = sum((torch.sum(g * g) for g, sh in zip(grads, self.shards) if sh is not None),
                      zero)
        whole = sum((torch.sum(g * g) for g, sh in zip(grads, self.shards) if sh is None), zero)
        bad = torch.stack([~torch.isfinite(g).all() for g in grads]).sum().float()
        # replicated leaves are counted once: each rank adds its copy's share
        v = self._model_sum(torch.stack([sharded, whole, bad]))
        return torch.sqrt(v[0] + v[1] / self.tp), v[2] == 0

    # ------------------------------------------------------------------ #
    def _adamw(self, i: int, g, p, lr, bc1, bc2, commit):
        """Parameter i's AdamW update; its moments are written where
        `commit` (else kept)."""
        b1, b2 = ADAM_B1, ADAM_B2
        mu, nu = self.state["mu"][i], self.state["nu"][i]
        m = (1 - b1) * g + b1 * mu
        v = (1 - b2) * (g * g) + b2 * nu
        u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        u = (-lr) * (u + WEIGHT_DECAY * p)
        mu.copy_(torch.where(commit, m, mu))
        nu.copy_(torch.where(commit, v, nu))
        return u

    def _adafactor(self, i: int, g, p, lr, decay, commit):
        """Parameter i's Adafactor update, computed in the Flax layout; its
        factored moments are written where `commit` (else kept)."""
        st = self.state
        vr, vc, v = st["v_row"][i], st["v_col"][i], st["v"][i]
        fg, fp = flax_view(g), flax_view(p)
        dims = self.factored[i]
        # a shard's Flax dim: means over it are taken over the whole dim
        sh = self.shards[i] if self.tp > 1 else None
        s = None if sh is None else flax_dim(p.ndim, sh.dim)

        def whole_mean(t, shard_dim):
            return self._model_sum(t) / self.tp if s == shard_dim else t

        g2 = fg * fg + 1e-30
        if dims is not None:
            d1, d0 = dims
            new_vr = decay * vr + (1.0 - decay) * whole_mean(torch.mean(g2, dim=d0), d0)
            new_vc = decay * vc + (1.0 - decay) * whole_mean(torch.mean(g2, dim=d1), d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = whole_mean(torch.mean(new_vr, dim=reduced_d1, keepdim=True), d1)
            row_factor = (new_vr / row_col_mean) ** -0.5
            col_factor = new_vc ** -0.5
            u = fg * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            vr.copy_(torch.where(commit, new_vr, vr))
            vc.copy_(torch.where(commit, new_vc, vc))
        else:
            new_v = decay * v + (1.0 - decay) * g2
            u = fg * new_v ** -0.5
            v.copy_(torch.where(commit, new_v, v))
        # clip_by_block_rms(1.0), the learning rate, the parameter's RMS
        if sh is None:
            u_ms, p_ms = torch.mean(u * u), torch.mean(fp * fp)
        else:
            u_ms, p_ms = self._model_sum(torch.stack([torch.sum(u * u), torch.sum(fp * fp)])) / (
                fp.numel() * self.tp)
        u = u / torch.clamp(torch.sqrt(u_ms), min=1.0)
        u = lr * u
        rms = torch.sqrt(p_ms)
        u = -(u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms))
        return u.permute(3, 2, 0, 1) if u.ndim == 4 else (u.t() if u.ndim == 2 else u)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None,
             isfinite: Optional[torch.Tensor] = None) -> None:
        """One optax update with `grads` (one per parameter, in order):
        writes the parameters and the state in place, one parameter at a
        time (no second copy of the moments). `grad_norm` and `isfinite`
        (`norm_and_finite` of the gradients) save recomputing them."""
        st = self.state
        grads = list(grads)
        if isfinite is None:
            isfinite = self.norm_and_finite(grads)[1]
        notfinite = torch.where(isfinite, torch.zeros_like(st["notfinite_count"]),
                                st["notfinite_count"] + 1)
        accept = isfinite | (notfinite > MAX_CONSECUTIVE_ERRORS)
        count = st["count"]
        if self.accumulation > 1:
            # MultiSteps: the Welford mean of the micro-gradients goes to
            # the inner chain, whose state moves only on the k-th step
            k, mini = self.accumulation, st["mini_step"]
            emit = mini == (k - 1)
            emit_f = emit.to(torch.float32)
            inner = [a + (g - a) / (mini + 1) for g, a in zip(grads, st["acc"])]
            commit = accept & emit
            norm = None
        else:
            inner, commit, norm = grads, accept, grad_norm
        if self.clip > 0:
            g_norm = self.norm_and_finite(inner)[0] if norm is None else norm
            trigger = g_norm < self.clip
        lr = self.schedule(count)
        inc = count + 1
        if self.kind == "adamw":
            one = torch.ones((), dtype=torch.float32, device=count.device)
            bc1 = 1.0 - torch.pow(one * ADAM_B1, inc.to(torch.float32))
            bc2 = 1.0 - torch.pow(one * ADAM_B2, inc.to(torch.float32))
        else:
            decay = 1.0 - torch.pow(inc.to(torch.float32), -0.8)
        for i, (g, p) in enumerate(zip(inner, self.params)):
            if self.clip > 0:
                g = torch.where(trigger, g, g / g_norm * self.clip)
            if self.kind == "adamw":
                u = self._adamw(i, g, p, lr, bc1, bc2, commit)
            else:
                u = self._adafactor(i, g, p, lr, decay, commit)
            if self.accumulation > 1:
                u = u * emit_f
                acc = st["acc"][i]
                acc.copy_(torch.where(accept, inner[i] * (1.0 - emit_f), acc))
            p.add_(torch.where(accept, u, torch.zeros_like(u)))
        st["count"] = torch.where(commit, inc, count)
        if self.accumulation > 1:
            st["mini_step"] = torch.where(accept, (mini + 1) % k, mini)
            st["gradient_step"] = torch.where(commit, st["gradient_step"] + 1,
                                              st["gradient_step"])
        st["total_notfinite"] = torch.where(isfinite, st["total_notfinite"],
                                            st["total_notfinite"] + 1)
        st["notfinite_count"] = notfinite
        st["last_finite"] = isfinite

    # ------------------------------------------------------------------ #
    def state_dict(self, whole: bool = False, out_device=None) -> Dict[str, object]:
        """The state; with `whole`, over a tensor-parallel state, the
        one-process layout on `out_device` (every rank of the model axis
        must call it)."""
        if not whole or self.tp == 1:
            return {k: (list(v) if isinstance(v, list) else v) for k, v in self.state.items()}
        out: Dict[str, object] = {}
        for k, v in self.state.items():
            if isinstance(v, list):
                out[k] = whole_tensors([(t, self._moment_shard(k, i)) for i, t in enumerate(v)],
                                       out_device)
            else:
                out[k] = v.to(out_device) if out_device is not None else v
        return out

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        if set(sd) != set(self.state):
            raise KeyError(f"optimizer state keys {sorted(sd)} != {sorted(self.state)}")
        for k, v in sd.items():
            cur = self.state[k]
            if isinstance(cur, list):
                if len(v) != len(cur):
                    raise ValueError(f"optimizer state {k}: {len(v)} tensors, expected {len(cur)}")
                for c, n in zip(cur, v):
                    c.copy_(n)
            else:
                cur.copy_(v)


def build_optimizer(config, steps_per_epoch: int, params: Sequence[torch.Tensor]) -> ChainOptimizer:
    """The JAX package's `build_optimizer(config, steps_per_epoch)` over
    `params`."""
    name = getattr(config, "optimizer", "adamw") or "adamw"
    if name not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer: {name!r}")
    return ChainOptimizer(params, build_lr_schedule(config, steps_per_epoch), kind=name,
                          clip_grad_norm=config.clip_grad_norm or 0.0,
                          accumulation=config.gradient_accumulation_steps)


@dataclass
class TrainState:
    """The training state: the step count (the number of train-step calls,
    rejected ones included, as the JAX TrainState.step), the trained model
    (its parameters are the state's params), the optimizer, the
    loss-aware sampler's state and the seed. The seed is the generator
    state: step i draws from a generator seeded with (seed, i)
    (`train_loop.step_draws`), as the JAX state's key is folded with i.
    """

    step: torch.Tensor  # int64, on the model's device
    model: torch.nn.Module
    optimizer: ChainOptimizer
    sampler_state: SamplerState
    seed: int = 0

    def state_dict(self) -> Dict[str, object]:
        """The one-process layout: a tensor-parallel state is gathered (on
        the CPU; every rank of the model axis must call it)."""
        opt = self.optimizer
        if opt.tp > 1:
            params, opt_state = gather_params_tp(self.model, "cpu"), opt.state_dict(True, "cpu")
        else:
            params, opt_state = self.model.state_dict(), opt.state_dict()
        return {"step": self.step, "params": params, "opt_state": opt_state,
                "sampler_state": {"loss_history": self.sampler_state.loss_history,
                                  "loss_counts": self.sampler_state.loss_counts},
                "seed": torch.tensor(int(self.seed), dtype=torch.int64)}

    def load_state_dict(self, sd: Dict[str, object]) -> None:
        self.step.copy_(sd["step"])
        self.model.load_state_dict(sd["params"], strict=True)
        self.optimizer.load_state_dict(sd["opt_state"])
        self.sampler_state.loss_history.copy_(sd["sampler_state"]["loss_history"])
        self.sampler_state.loss_counts.copy_(sd["sampler_state"]["loss_counts"])
        self.seed = int(sd["seed"])


def create_train_state(config, model: torch.nn.Module, steps_per_epoch: int, seed: int = 0,
                       optimizer: Optional[ChainOptimizer] = None) -> TrainState:
    """`optimizer` lets the caller pass the one it built; else one is built
    over the model's parameters."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optimizer is None:
        optimizer = build_optimizer(config, steps_per_epoch, params)
    dev = params[0].device
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=dev), model=model,
                      optimizer=optimizer,
                      sampler_state=init_loss_aware_state(config.num_train_timesteps, device=dev),
                      seed=int(seed))


class StepCounter:
    """Host-side epoch/step bookkeeping + running loss average for
    abnormal-loss detection."""

    def __init__(self, horizon: int = 100):
        self.epoch = 0
        self.local_step = 0
        self.global_step = 0
        self.horizon = horizon
        self._losses: list = []
        # best in-training eval EPE; persisted so a resumed run cannot
        # overwrite best/ with a worse post-resume eval
        self.best_epe = float("inf")

    def tick(self, loss: Optional[float] = None):
        self.local_step += 1
        self.global_step += 1
        if loss is not None:
            self.record(loss)

    def record(self, loss: float):
        """Record a step loss; split from tick() so the train loop can
        advance counters at dispatch time and fetch the loss one step
        late."""
        self._losses.append(float(loss))
        if len(self._losses) > self.horizon:
            self._losses.pop(0)

    def new_epoch(self):
        self.epoch += 1
        self.local_step = 0

    @property
    def avg_loss(self) -> float:
        return sum(self._losses) / len(self._losses) if self._losses else 0.0

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "local_step": self.local_step,
                "global_step": self.global_step, "losses": list(self._losses),
                "best_epe": self.best_epe}

    def load_state_dict(self, sd: dict):
        self.epoch = sd["epoch"]
        self.local_step = sd["local_step"]
        self.global_step = sd["global_step"]
        self._losses = list(sd.get("losses", []))
        self.best_epe = float(sd.get("best_epe", float("inf")))
