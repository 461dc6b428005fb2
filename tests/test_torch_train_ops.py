"""The training slice's ops against the JAX package's: the forward-process
noise (randn and the pyramid, its level draws replayed), the loss-aware
timestep sampler's update (duplicate timesteps in one batch, the ring's
shift), its weights' warm-up and the importance weights of sampled
timesteps, and the schedule's velocity and SNR.

Tolerances: the pyramid within 2e-6 of its largest magnitude (its upsample
and the std are float32 in both and sum in another order; a wrong resize,
a missing level or the unbiased std moves values by 1e-3 or more); everything else exact or within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import noise as jnoise
from d3roma_tpu.ops import resample as jres
from d3roma_tpu.ops.schedules import ScheduleConfig as JaxScheduleConfig
from d3roma_tpu.ops.schedules import get_velocity as jax_velocity
from d3roma_tpu.ops.schedules import snr as jax_snr
from d3roma_tpu_torch.ops import resample as res
from d3roma_tpu_torch.ops.noise import GeneratorDraws, make_noise
from d3roma_tpu_torch.ops.schedules import ScheduleConfig, get_velocity, snr
from torch_port_utils import ReplayDraws, jax_pyramid_draws


@pytest.mark.parametrize("shape", [(2, 23, 37, 4), (1, 45, 80, 4), (3, 16, 16, 1)])
def test_pyramid_noise(shape):
    key = jax.random.PRNGKey(7)
    ref = np.array(jnoise.make_noise(key, shape, "pyramid"))
    ours = make_noise(ReplayDraws(jax_pyramid_draws(key, shape)), shape, "pyramid").numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    assert abs(float(np.std(ours)) - 1.0) < 1e-5  # the population std


def test_randn_noise():
    key = jax.random.PRNGKey(3)
    shape = (2, 5, 6, 4)
    ref = np.array(jnoise.make_noise(key, shape, "randn"))
    draw = np.array(jax.random.normal(key, shape, np.float32))
    ours = make_noise(ReplayDraws([draw]), shape, "randn").numpy()
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        make_noise(ReplayDraws([draw]), shape, "uniform")


def test_generator_draws_on_the_generator():
    gen = torch.Generator().manual_seed(0)
    d = GeneratorDraws(gen)
    n = make_noise(d, (2, 23, 37, 4), "pyramid")
    assert n.shape == (2, 23, 37, 4) and torch.isfinite(n).all()
    t = d.randint(0, 10, 64)
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) < 10
    p = torch.tensor([0.0, 0.25, 0.75])
    c = d.categorical(p, 400)
    assert int((c == 0).sum()) == 0 and int((c == 2).sum()) > int((c == 1).sum())


def _state(T, H, fill_seed=None, counts=None):
    rs = np.random.RandomState(fill_seed or 0)
    hist = rs.rand(T, H).astype(np.float32) if fill_seed is not None else np.zeros((T, H), np.float32)
    cnt = np.full((T,), H, np.int32) if counts is None else np.asarray(counts, np.int32)
    return hist, cnt


def test_update_loss_aware_duplicates_in_order():
    """Duplicate timesteps stack in batch order; a full ring shifts out
    its oldest entry, as the JAX scan does."""
    T, H = 6, 4
    hist, cnt = _state(T, H, fill_seed=1, counts=[0, 1, 3, 4, 4, 2])
    ts = np.array([2, 2, 2, 0, 4, 4, 1, 2, 5, 5, 5], np.int32)
    losses = np.arange(1, len(ts) + 1, dtype=np.float32) * 0.5
    ref = jres.update_loss_aware(jres.SamplerState(jnp.asarray(hist), jnp.asarray(cnt)),
                                 jnp.asarray(ts), jnp.asarray(losses))
    ours = res.update_loss_aware(res.SamplerState(torch.from_numpy(hist), torch.from_numpy(cnt)),
                                 torch.from_numpy(ts), torch.from_numpy(losses))
    np.testing.assert_array_equal(ours.loss_history.numpy(), np.array(ref.loss_history))
    np.testing.assert_array_equal(ours.loss_counts.numpy(), np.array(ref.loss_counts))
    assert ours.loss_counts.dtype == torch.int32


def test_loss_aware_weights_warm_up():
    """Uniform until every timestep's ring is full, then sqrt(E[loss^2])
    with the uniform floor."""
    T, H = 8, 3
    for counts in ([H] * (T - 1) + [H - 1], [H] * T):
        hist, cnt = _state(T, H, fill_seed=2, counts=counts)
        ref = np.array(jres.loss_aware_weights(jres.SamplerState(jnp.asarray(hist),
                                                                 jnp.asarray(cnt))))
        ours = res.loss_aware_weights(res.SamplerState(torch.from_numpy(hist),
                                                       torch.from_numpy(cnt))).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert not np.allclose(ours, 1.0 / T)  # warmed: no longer uniform


def test_sample_timesteps_importance_weights():
    T = 16
    w = np.random.RandomState(4).rand(T).astype(np.float32) + 0.05
    key = jax.random.PRNGKey(11)
    t_ref, w_ref = jres.sample_timesteps(key, jnp.asarray(w), 12)
    p = w / w.sum()
    draw = np.array(jax.random.categorical(key, jnp.log(jnp.maximum(jnp.asarray(p), 1e-20)),
                                           shape=(12,)))
    np.testing.assert_array_equal(draw, np.array(t_ref))
    t, iw = res.sample_timesteps(ReplayDraws([draw]), torch.from_numpy(w), 12)
    np.testing.assert_array_equal(t.numpy(), np.array(t_ref))
    np.testing.assert_allclose(iw.numpy(), np.array(w_ref), rtol=1e-6)
    # and on the port's own generator: indices in range, E[w] over p is 1
    t2, iw2 = res.sample_timesteps(GeneratorDraws(torch.Generator().manual_seed(0)),
                                   torch.from_numpy(w), 4096)
    assert 0 <= int(t2.min()) and int(t2.max()) < T
    assert abs(float(iw2.mean()) - 1.0) < 0.1


def test_named_samplers_and_velocity():
    cfg = dict(num_train_timesteps=50, beta_schedule="scaled_linear", beta_start=0.00085,
               beta_end=0.012)
    jt, pt = JaxScheduleConfig(**cfg).tables(), ScheduleConfig(**cfg).tables("cpu")
    t = np.array([0, 7, 49, 20], np.int32)
    x0 = np.random.RandomState(0).randn(4, 3, 5, 2).astype(np.float32)
    n = np.random.RandomState(1).randn(4, 3, 5, 2).astype(np.float32)
    np.testing.assert_allclose(
        get_velocity(pt, torch.from_numpy(x0), torch.from_numpy(n), torch.from_numpy(t)).numpy(),
        np.array(jax_velocity(jt, jnp.asarray(x0), jnp.asarray(n), jnp.asarray(t))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(snr(pt, torch.from_numpy(t)).numpy(),
                               np.array(jax_snr(jt, jnp.asarray(t))), rtol=1e-6)
    for name in ("uniform", "snr", "loss-second-moment"):
        fn, st = res.create_named_schedule_sampler(name, 50, pt)
        jfn, jst = jres.create_named_schedule_sampler(name, 50, jt)
        np.testing.assert_allclose(fn(st).numpy(), np.array(jfn(jst)), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        res.create_named_schedule_sampler("other", 50)


def test_abnormal_loss_detector_matches_jax(tmp_path):
    """The forensics copy: the same verdicts on the same losses, and the
    same dump, with the port's batch and metrics as torch tensors."""
    from d3roma_tpu.training.forensics import AbnormalLossDetector as JaxDetector
    from d3roma_tpu_torch.training.forensics import AbnormalLossDetector

    rs = np.random.RandomState(0)
    batch = {"disp": rs.rand(2, 4, 4, 1).astype(np.float32), "path": ["a.png", "b.png"]}
    metrics = {"loss": np.float32(7.0), "timesteps": np.array([3, 9], np.int32)}
    ours = AbnormalLossDetector(str(tmp_path / "port"), min_history=2, max_dumps=1)
    ref = JaxDetector(str(tmp_path / "jax"), min_history=2, max_dumps=1)
    tbatch = {"disp": torch.from_numpy(batch["disp"]), "path": batch["path"]}
    tmetrics = {k: torch.from_numpy(np.asarray(v)) for k, v in metrics.items()}
    for step, (loss, avg, hist) in enumerate([(1.0, 1.0, 5), (500.0, 1.0, 5), (float("nan"), 1.0, 5),
                                              (500.0, 1.0, 1)]):
        got = ours.check(loss, avg, hist, step, tbatch, tmetrics, paths=batch["path"])
        want = ref.check(loss, avg, hist, step, batch, metrics, paths=batch["path"])
        assert got == want
    a = np.load(tmp_path / "port" / "checkpoints" / "1_dump" / "dump.npz")
    b = np.load(tmp_path / "jax" / "checkpoints" / "1_dump" / "dump.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert not (tmp_path / "port" / "checkpoints" / "2_dump").exists()  # max_dumps


def test_device_prefetch_keeps_order_and_drops_lists():
    from d3roma_tpu_torch.data.prefetch import device_prefetch, to_device

    raw = [{"x": np.full((2,), i, np.float32), "path": [f"{i}"]} for i in range(5)]
    prepared = []
    out = list(device_prefetch(raw, prepare=lambda b: prepared.append(1) or to_device(b, "cpu"),
                               size=2))
    assert [int(b["x"][0]) for b in out] == list(range(5)) and len(prepared) == 5
    assert all(set(b) == {"x"} and b["x"].dtype == torch.float32 for b in out)
