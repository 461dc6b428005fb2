"""The port's optimizer chain (training/state.py) against optax, as the JAX
package builds it (d3roma_tpu/training/state.py::build_optimizer): the same
parameters and the same synthetic gradients, 20 updates, in every case of
schedule, clip, accumulation and optimizer, with a rejected NaN gradient,
and more than 100 non-finite gradients in a row (then accepted).

Tolerances: parameters and optimizer moments within 1e-6 relative for
AdamW and 1e-5 for Adafactor, relative to each array's largest magnitude
(an element near zero carries the rounding of its larger neighbours). Both run the same float32 formulas; what
differs is rounding (XLA fuses the jitted update, and takes powers and
means in another order), a few ulps a step, far below either bound, while
a wrong constant, a wrong order of the chain or a misplaced bias
correction moves the parameters by percent.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_utils  # noqa: F401  (one intra-op thread)
from d3roma_tpu.training.state import build_lr_schedule as jax_schedule
from d3roma_tpu.training.state import build_optimizer as jax_build_optimizer
from d3roma_tpu_torch.training.state import build_lr_schedule, build_optimizer, flax_view

# Flax-layout shapes: a conv kernel HWIO whose two largest axes factor
# (and one with equal largest axes), a dense kernel, a small conv kernel
# that does not factor, a norm scale and a bias
SHAPES = {"conv": (3, 3, 130, 140), "conv_tie": (1, 1, 128, 128), "dense": (136, 129),
          "small": (3, 3, 4, 8), "scale": (8,), "bias": (140,)}
STEPS = 20


def _config(**kw):
    cfg = dict(learning_rate=1e-3, lr_warmup_steps=3, gradient_accumulation_steps=1,
               num_epochs=2, lr_scheduler="constant", num_cycles=2, clip_grad_norm=1.0,
               optimizer="adamw")
    cfg.update(kw)
    return SimpleNamespace(**cfg)


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {k: (rs.standard_normal(s) * (0.5 if len(s) > 1 else 0.1)).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, nan_steps=()):
    rs = np.random.RandomState(100 + step)
    # norms from ~0.3 to ~8: the clip at 1.0 triggers on some steps only
    scale = 10 ** rs.uniform(-3.2, -1.8)
    g = {k: (rs.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    if step in nan_steps:
        g["dense"][3, 5] = np.nan
    return g


def _close(ours, ref, rtol, name):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rtol * np.nanmax(np.abs(ref)),
                               err_msg=name)


def _to_torch(tree):
    """Flax layout -> the torch parameter layout (OIHW, [out, in])."""
    out = []
    for k in SHAPES:
        t = torch.from_numpy(np.array(tree[k]))
        out.append(t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4
                   else (t.t().contiguous() if t.ndim == 2 else t))
    return out


def _run(cfg, steps=STEPS, nan_steps=()):
    steps_per_epoch = 10
    params = jax.tree.map(jnp.asarray, _params())
    tx = jax_build_optimizer(cfg, steps_per_epoch)
    state = tx.init(params)
    update = jax.jit(tx.update)
    tparams = [p.clone() for p in _to_torch(_params())]
    opt = build_optimizer(cfg, steps_per_epoch, tparams)
    for i in range(steps):
        g = _grads(i, nan_steps)
        updates, state = update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        opt.step(_to_torch(g))
    return params, state, tparams, opt


def _inner_adam_state(state):
    """The ScaleByAdamState inside apply_if_finite / MultiSteps / chain."""
    inner = state.inner_state
    if hasattr(inner, "inner_opt_state"):
        inner = inner.inner_opt_state
    for s in jax.tree.leaves(inner, is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "v_row")):
        if hasattr(s, "mu") or hasattr(s, "v_row"):
            return s
    raise AssertionError("no moments in the optax state")


def _check(cfg, params, state, tparams, opt, rtol):
    start = _params()
    for k, ours in zip(SHAPES, tparams):
        _close(flax_view(ours).numpy(), params[k], rtol, k)
        # the updates moved every parameter far beyond the tolerance
        assert np.max(np.abs(np.array(params[k]) - start[k])) > 100 * rtol * np.max(
            np.abs(start[k])), k
    moments = _inner_adam_state(state)
    if cfg.optimizer == "adamw":
        pairs = (("mu", opt.state["mu"]), ("nu", opt.state["nu"]))
    else:
        pairs = (("v_row", opt.state["v_row"]), ("v_col", opt.state["v_col"]),
                 ("v", opt.state["v"]))
    for name, ours in pairs:
        for k, o in zip(SHAPES, ours):
            ref = np.array(getattr(moments, name)[k])
            mine = flax_view(o).numpy() if name in ("mu", "nu") else o.numpy()
            _close(mine, ref, rtol, f"{name} {k}")
    assert int(opt.state["count"]) == int(moments.count)
    assert int(opt.state["notfinite_count"]) == int(state.notfinite_count)
    assert int(opt.state["total_notfinite"]) == int(state.total_notfinite)


CASES = {
    "constant": dict(),
    "cosine": dict(lr_scheduler="cosine", lr_warmup_steps=4),
    "linear": dict(lr_scheduler="linear"),
    "no_clip": dict(clip_grad_norm=0.0),
    "accum2": dict(gradient_accumulation_steps=2, lr_scheduler="cosine"),
    "adafactor": dict(optimizer="adafactor", lr_scheduler="cosine"),
    "adafactor_accum2_no_clip": dict(optimizer="adafactor", gradient_accumulation_steps=2,
                                     clip_grad_norm=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_optax(case):
    cfg = _config(**CASES[case])
    rtol = 1e-5 if cfg.optimizer == "adafactor" else 1e-6
    _check(cfg, *_run(cfg), rtol)


@pytest.mark.parametrize("accum", [1, 2])
def test_nan_gradient_rejected(accum):
    """A NaN gradient at update 5 changes nothing (params, moments, the
    accumulator, the schedule's count); the run goes on as optax's."""
    cfg = _config(gradient_accumulation_steps=accum, lr_scheduler="linear")
    params, state, tparams, opt = _run(cfg, nan_steps=(5,))
    _check(cfg, params, state, tparams, opt, 1e-6)
    assert int(opt.state["total_notfinite"]) == 1
    assert all(torch.isfinite(p).all() for p in tparams)


def test_more_than_100_nonfinite_in_a_row_accepted():
    """apply_if_finite gives up after 100 rejections in a row: the 101st
    non-finite gradient is applied, in both."""
    cfg = _config(lr_warmup_steps=0)
    steps = 103
    params, state, tparams, opt = _run(cfg, steps=steps, nan_steps=range(1, steps))
    assert int(state.notfinite_count) == int(opt.state["notfinite_count"]) == steps - 1
    assert int(opt.state["count"]) == int(_inner_adam_state(state).count) == 3
    for k, ours in zip(SHAPES, tparams):
        np.testing.assert_array_equal(np.isnan(flax_view(ours).numpy()),
                                      np.isnan(np.array(params[k])))
    assert torch.isnan(tparams[2]).any()


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_lr_schedules(kind):
    """The schedules as pure functions of the update count, warmup first."""
    cfg = _config(lr_scheduler=kind, lr_warmup_steps=5, num_epochs=3, num_cycles=3)
    ref = jax_schedule(cfg, 17)
    ours = build_lr_schedule(cfg, 17)
    counts = np.arange(0, 60)
    want = np.array([float(ref(jnp.int32(c))) for c in counts], np.float32)
    got = np.array([float(ours(torch.tensor(int(c), dtype=torch.int32))) for c in counts],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0 and got[5] > 0
