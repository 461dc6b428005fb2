"""The SSI normalizer and its scale/shift fits (ops/scale_shift.py,
ops/normalizer.py) against the JAX package's, on the same numpy inputs.

- Least squares: the same fits to 1e-5 relative, the degenerate masks
  (empty, one pixel, a constant prediction) taking the identity.
- RANSAC with the JAX package's own subsets, `permutation(fold_in(key, i),
  N)[:int(0.1 N)]`, passed explicitly: the same fits to 1e-5.
- SSI normalize (quantile window, an all-invalid frame, a constant frame,
  percentiles other than min/max) and denormalize (LSQ and RANSAC): 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import normalizer as jax_norm
from d3roma_tpu.ops import scale_shift as jax_ss
from d3roma_tpu_torch.ops import normalizer as port_norm
from d3roma_tpu_torch.ops import scale_shift as port_ss
from torch_port_utils import randn

TOL = 1e-5


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1))


def _jax_subsets(key, n, k_iters=10, n_frac=0.1):
    n_sample = max(1, int(n_frac * n))
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, i), n)[:n_sample])
                     for i in range(k_iters)])


def _scene(seed, b=3, n=400, outliers=0.2):
    """pred, target = 2.5 pred - 0.7 + noise with a share of outliers, and
    a mask with some pixels off."""
    rs = np.random.RandomState(seed)
    pred = rs.uniform(-1, 1, (b, n)).astype(np.float32)
    target = (2.5 * pred - 0.7 + 0.05 * rs.standard_normal((b, n))).astype(np.float32)
    bad = rs.uniform(size=(b, n)) < outliers
    target[bad] += rs.uniform(2, 6, bad.sum()).astype(np.float32)
    mask = (rs.uniform(size=(b, n)) > 0.1).astype(np.float32)
    return pred, target, mask


def test_least_squares_and_degenerate_masks():
    pred, target, mask = _scene(0, b=5)
    mask[1] = 0.0  # empty
    mask[2] = 0.0
    mask[2, 7] = 1.0  # one pixel: det = 0
    pred[3] = 0.25  # constant prediction: det = 0
    ref = jax_ss.compute_scale_and_shift(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = port_ss.compute_scale_and_shift(torch.from_numpy(pred), torch.from_numpy(target),
                                          torch.from_numpy(mask))
    _close(got, ref)
    np.testing.assert_array_equal(got[1:4].numpy(), [[1, 0]] * 3)
    assert abs(got[0, 0].item() - 2.5) < 0.5
    # no mask: every pixel
    ref = jax_ss.compute_scale_and_shift(jnp.asarray(pred), jnp.asarray(target))
    _close(port_ss.compute_scale_and_shift(torch.from_numpy(pred), torch.from_numpy(target)), ref)


def test_accuracy_inverse():
    pred, target, mask = _scene(1)
    pred[0, :5] = 0.0
    ref = jax_ss._accuracy_inverse(jnp.asarray(target), jnp.asarray(pred), jnp.asarray(mask))
    _close(port_ss._accuracy_inverse(torch.from_numpy(target), torch.from_numpy(pred),
                                     torch.from_numpy(mask)), ref)


@pytest.mark.parametrize("seed", [2, 3])
def test_ransac_with_jax_subsets(seed):
    pred, target, mask = _scene(seed, b=4, n=500)
    mask[3] = 0.0  # nothing to fit: the identity stays
    key = jax.random.PRNGKey(seed)
    ref = jax_ss.ransac_scale_shift(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
                                    key, error_threshold=0.6)
    got = port_ss.ransac_scale_shift(torch.from_numpy(pred), torch.from_numpy(target),
                                     torch.from_numpy(mask), error_threshold=0.6,
                                     subsets=torch.from_numpy(_jax_subsets(key, 500)))
    _close(got, ref)
    np.testing.assert_array_equal(got[3].numpy(), [1, 0])
    assert np.abs(got[:3, 0].numpy() - 2.5).max() < 0.1  # the outliers rejected
    # subsets from a generator: reproducible, a fit found where there is data
    gen_fit = [port_ss.ransac_scale_shift(torch.from_numpy(pred), torch.from_numpy(target),
                                          torch.from_numpy(mask),
                                          torch.Generator().manual_seed(1))
               for _ in range(2)]
    assert torch.equal(*gen_fit) and (gen_fit[0][:3, 0] > 1.5).all()
    np.testing.assert_array_equal(gen_fit[0][3].numpy(), [1, 0])
    with pytest.raises(ValueError):
        port_ss.ransac_scale_shift(torch.from_numpy(pred), torch.from_numpy(target),
                                   torch.from_numpy(mask))


def test_masked_quantile():
    x = randn(4, 3, 50)
    mask = randn(5, 3, 50) > -0.5
    mask[2] = False
    qs = [0.0, 0.02, 0.37, 0.98, 1.0]
    ref = jax_norm.masked_quantile(jnp.asarray(x), jnp.asarray(mask), qs, axis=1)
    got = port_norm.masked_quantile(torch.from_numpy(x), torch.from_numpy(mask), qs)
    assert np.isnan(np.asarray(ref)[:, 2]).all() and torch.isnan(got[:, 2]).all()
    _close(got[:, [0, 1]], np.asarray(ref)[:, [0, 1]])


def _disp_batch():
    disp = np.abs(randn(7, 4, 12, 10, 1, scale=20.0)) + 3.0
    mask = randn(8, 4, 12, 10, 1) > -1.0
    mask[1] = False  # an all-invalid frame
    disp[2] = 17.0  # a constant frame: up == low
    return disp, mask


@pytest.mark.parametrize("low_p,high_p", [(0.0, 1.0), (0.05, 0.9)])
def test_ssi_normalize(low_p, high_p):
    disp, mask = _disp_batch()
    kw = dict(ssi=True, low_p=low_p, high_p=high_p)
    ref = jax_norm.Normalizer(**kw).normalize(jnp.asarray(disp), jnp.asarray(mask))
    got = port_norm.Normalizer(**kw).normalize(torch.from_numpy(disp), torch.from_numpy(mask))
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a, b)
    # degenerate frames take the (0, 1) window
    assert got[1][1:3].flatten().tolist() == [0.0, 0.0] and got[2][1:3].flatten().tolist() == [1, 1]
    # one frame [H, W, 1], no mask, and a given window
    ref = jax_norm.Normalizer(**kw).normalize(jnp.asarray(disp[0]))
    got = port_norm.Normalizer(**kw).normalize(torch.from_numpy(disp[0]))
    for a, b in zip(got, ref):
        _close(a, b)
    low, up = np.float32(5.0), np.float32(30.0)
    ref = jax_norm.Normalizer(**kw).normalize(jnp.asarray(disp), jnp.asarray(mask), low, up)
    got = port_norm.Normalizer(**kw).normalize(torch.from_numpy(disp), torch.from_numpy(mask),
                                               torch.tensor(low), torch.tensor(up))
    _close(got[0], ref[0])


@pytest.mark.parametrize("safe_ssi", [False, True])
def test_ssi_denormalize(safe_ssi):
    disp, mask = _disp_batch()
    rounds = np.concatenate([randn(9, 4, 12, 10, 1), randn(10, 4, 12, 10, 1)], axis=-1)
    kw = dict(ssi=True, safe_ssi=safe_ssi, ransac_error_threshold=30.0)
    key = jax.random.PRNGKey(6)
    ref = jax_norm.Normalizer(**kw).denormalize(jnp.asarray(rounds), jnp.asarray(disp),
                                                jnp.asarray(mask), key=key)
    subsets = torch.from_numpy(_jax_subsets(key, 12 * 10)) if safe_ssi else None
    got = port_norm.Normalizer(**kw).denormalize(torch.from_numpy(rounds), torch.from_numpy(disp),
                                                 torch.from_numpy(mask), subsets=subsets)
    assert tuple(got.shape) == (4, 12, 10, 2)
    _close(got, ref)
    with pytest.raises(ValueError):
        port_norm.Normalizer(**kw).denormalize(torch.from_numpy(rounds))


def test_from_config_fields_and_rgb():
    cfg = types.SimpleNamespace(ssi=True, normalize_mode="average", num_chs=1, ch_bounds=[128.0],
                                ch_gammas=[1.0], norm_t=0.5, norm_s=2.0, safe_ssi=False,
                                ransac_error_threshold=0.4, ssi_low_p=0.01)
    assert (dataclasses.asdict(port_norm.Normalizer.from_config(cfg))
            == dataclasses.asdict(jax_norm.Normalizer.from_config(cfg)))
    assert ([f.name for f in dataclasses.fields(port_norm.Normalizer)]
            == [f.name for f in dataclasses.fields(jax_norm.Normalizer)])
    assert (dataclasses.asdict(port_norm.Normalizer())
            == dataclasses.asdict(jax_norm.Normalizer()))
    img = np.random.RandomState(0).randint(0, 256, (2, 3, 4, 3)).astype(np.float32)
    ref = jax_norm.normalize_rgb(jnp.asarray(img), None)
    got = port_norm.normalize_rgb(torch.from_numpy(img), None)
    assert got[1] is None
    _close(got[0], ref[0])
