"""The port's NCC block matcher (d3roma_tpu_torch/ops/stereo.py) against the
JAX package's (d3roma_tpu/ops/stereo.py) on the CPU, at the JAX tests'
sizes: a textured pair with a known 12 px disparity, 1x64x160, D 5..20,
block 11, and the same at batch 2 with 3 channels.

Tolerances. The box sums run in another order (windows along W, then H,
where XLA's reduce_window sums the k x k window its own way), and the
variance terms cancel, so the cost volumes agree to COST_ATOL (measured
~8e-5 on costs in [-1, 1]); the soft-argmax on one cost volume to
SOFTARGMAX_ATOL on VALID_AGREE of the pixels and SOFTARGMAX_MAX px on all
(the sub-pixel term divides by the cost's curvature, near zero at a few
pixels, where a last-place difference of XLA's fused arithmetic moves it:
measured 1.7e-3); LRC and the median are
selections, bit-equal; the bilateral filter to FILTER_ATOL. The whole
`stereo_match` is discontinuous at the LRC threshold and the range cut,
and the softmax at beta 100 amplifies the cost differences: the same
validity on at least VALID_AGREE of the pixels, and the disparity within
DISP_ATOL px where both are valid (measured 0.017-0.055 px)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from d3roma_tpu.ops import stereo as jax_stereo
from d3roma_tpu_torch.ops import stereo

COST_ATOL = 5e-4
SOFTARGMAX_ATOL = 1e-5
SOFTARGMAX_MAX = 5e-3
FILTER_ATOL = 1e-5
VALID_AGREE = 0.995
DISP_ATOL = 0.15
CASES = {"b1c1": (1, 1), "b2c3": (2, 3)}
# jitted: one compile a shape, where eager JAX compiles every primitive
jax_cost = jax.jit(jax_stereo.ncc_cost_volume, static_argnums=(2, 3, 4))
jax_soft_argmax = jax.jit(jax_stereo.soft_argmax_disp, static_argnums=(1, 2, 3),
                          static_argnames=("sub_pixel",))
jax_lrc = jax.jit(jax_stereo.lrc_check)
jax_median = jax.jit(jax_stereo.median_blur, static_argnums=1)


def _pair(batch, channels, H=64, W=160, disp=12, seed=0):
    """Right = a smoothed random texture; left = right shifted by `disp`."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 1, (batch, H, W + disp, channels)).astype(np.float32)
    tex = ndi.gaussian_filter(tex, (0, 1.0, 1.0, 0)).astype(np.float32)
    return np.ascontiguousarray(tex[:, :, :W]), np.ascontiguousarray(tex[:, :, disp:])


@pytest.fixture(scope="module", params=sorted(CASES))
def volumes(request):
    left, right = _pair(*CASES[request.param])
    ref = [np.asarray(v) for v in
           jax_cost(jnp.asarray(left), jnp.asarray(right), 5, 20, 11)]
    ours = [v.numpy() for v in
            stereo.ncc_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 5, 20, 11)]
    return left, right, ref, ours


def test_cost_volumes_match_jax(volumes):
    _, _, ref, ours = volumes
    for r, o in zip(ref, ours):
        assert o.shape == r.shape == (16,) + r.shape[1:]
        np.testing.assert_allclose(o, r, rtol=0, atol=COST_ATOL)


def test_box_sum_is_exact_fp32():
    """The box sums against a float64 reference: fp32 rounding only (a TF32
    or divided-and-remultiplied sum misses by ~1e-3 relative)."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 20, 30, 3)).astype(np.float32)
    ours = stereo._box_sum(torch.from_numpy(x), 11).numpy()[..., 0]
    s = np.pad(x.astype(np.float64).sum(-1), ((0, 0), (5, 5), (5, 5)))
    want = sum(s[:, i:i + 20, j:j + 30] for i in range(11) for j in range(11))
    np.testing.assert_allclose(ours, want, rtol=1e-6, atol=0)
    ref = np.asarray(jax_stereo._box_sum(jnp.asarray(x), 11))[..., 0]
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sub_pixel", [True, False])
def test_soft_argmax_matches_jax(volumes, sub_pixel):
    _, _, ref, _ = volumes
    for cost in ref:
        want = np.asarray(jax_soft_argmax(jnp.asarray(cost), 5, 20, 100.0, sub_pixel=sub_pixel))
        got = stereo.soft_argmax_disp(torch.from_numpy(cost.copy()), 5, 20, 100.0,
                                      sub_pixel=sub_pixel).numpy()
        err = np.abs(got - want)
        assert (err <= SOFTARGMAX_ATOL).mean() >= VALID_AGREE, err.max()
        assert err.max() <= SOFTARGMAX_MAX, err.max()


def test_lrc_and_median_match_jax():
    rng = np.random.default_rng(2)
    dl = rng.uniform(3, 9, (2, 8, 16)).astype(np.float32)
    dr = (dl + rng.normal(0, 0.8, dl.shape)).astype(np.float32)
    want = np.asarray(jax_lrc(jnp.asarray(dl), jnp.asarray(dr)))
    got = stereo.lrc_check(torch.from_numpy(dl), torch.from_numpy(dr)).numpy()
    assert (want == -1).any() and (want != -1).any()
    np.testing.assert_array_equal(got, want)
    x = rng.normal(0, 1, (2, 16, 32)).astype(np.float32)
    x[0, 8, 8] = 100.0
    np.testing.assert_array_equal(stereo.median_blur(torch.from_numpy(x), 5).numpy(),
                                  np.asarray(jax_median(jnp.asarray(x), 5)))
    with pytest.raises(ValueError, match="odd"):
        stereo.median_blur(torch.from_numpy(x), 4)


@pytest.mark.parametrize("kw", [dict(sigma_color=1.0), dict(ksize=3), {}])
def test_bilateral_filter_matches_jax(kw):
    x = np.zeros((2, 16, 32), np.float32)
    x[:, :, 16:] = 10.0
    x += np.random.default_rng(0).normal(0, 0.1, x.shape).astype(np.float32)
    want = np.asarray(jax.jit(partial(jax_stereo.bilateral_filter, **kw))(jnp.asarray(x)))
    got = stereo.bilateral_filter(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL * np.abs(want).max())


def test_stereo_match_matches_jax(volumes):
    left, right, _, _ = volumes
    ref = jax_stereo.stereo_match(jnp.asarray(left), jnp.asarray(right), 24.0, 5, 20, 11)
    ours = stereo.stereo_match(torch.from_numpy(left), torch.from_numpy(right), 24.0, 5, 20, 11)
    rv, ov = np.asarray(ref.valid), ours.valid.numpy()
    assert rv.mean() > 0.8  # the matcher finds the shift on most pixels
    assert (rv == ov).mean() >= VALID_AGREE
    both = rv & ov
    np.testing.assert_allclose(ours.disp.numpy()[both], np.asarray(ref.disp)[both],
                               rtol=0, atol=DISP_ATOL)
    assert (ours.disp.numpy()[~ov] == -1).all() and (ours.depth.numpy()[~ov] == 0).all()
    np.testing.assert_allclose(ours.depth.numpy()[both], np.asarray(ref.depth)[both],
                               rtol=DISP_ATOL / 5)
    assert abs(np.median(ours.disp.numpy()[ov]) - 12) < 0.5


def test_chunked_cost_volume_is_the_same(monkeypatch):
    """The disparity chunks (set by the element budget) change nothing."""
    left, right = _pair(1, 1)
    whole = stereo.ncc_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 5, 20, 11)
    monkeypatch.setattr(stereo, "_CHUNK_ELEMS", 3 * 64 * 160)  # chunks of 3 disparities
    parts = stereo.ncc_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 5, 20, 11)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
