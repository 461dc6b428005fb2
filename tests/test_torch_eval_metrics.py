"""The evaluation slice's arithmetic against the JAX package: compute_errors
(disp and depth space, masked, with and without fxb), metrics_to_dict,
ensemble_depths (R = 1-4, median and mean: R = 2 and 4 are the even counts
where torch.median would return the lower middle value), InputPadder,
RunningAverager's anomaly rejection, evaluate_intermediate_metrics, and the
colour tables and figures of utils/viz.py against matplotlib.

Tolerances: compute_errors within 1e-6 of max |ref| per column (float32
masked means summed in another order); ensemble_depths within 1e-5 (30
Adam steps on float32 gradients that XLA and autograd reduce in another
order); everything else bit-equal."""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402

from d3roma_tpu.evaluation import RunningAverager as JaxAverager  # noqa: E402
from d3roma_tpu.evaluation import evaluate_intermediate_metrics as jax_intermediate  # noqa: E402
from d3roma_tpu.ops import InputPadder as JaxPadder  # noqa: E402
from d3roma_tpu.ops import compute_errors as jax_errors  # noqa: E402
from d3roma_tpu.ops import ensemble_depths as jax_ensemble  # noqa: E402
from d3roma_tpu.ops import metrics_to_dict as jax_to_dict  # noqa: E402
from d3roma_tpu.utils import viz as jax_viz  # noqa: E402
from d3roma_tpu_torch.config import TrainingConfig  # noqa: E402
from d3roma_tpu_torch.evaluation import RunningAverager, evaluate_intermediate_metrics  # noqa: E402
from d3roma_tpu_torch.ops.ensemble import ensemble_depths  # noqa: E402
from d3roma_tpu_torch.ops.metrics import compute_errors, metrics_to_dict  # noqa: E402
from d3roma_tpu_torch.ops.padding import InputPadder  # noqa: E402
from d3roma_tpu_torch.utils import colormaps, png, viz  # noqa: E402


def _case(seed, space):
    rs = np.random.RandomState(seed)
    gt = rs.uniform(2.0, 30.0, (3, 12, 20)).astype(np.float32)
    if space == "depth":
        gt = (10.0 / gt).astype(np.float32)
    pred = (gt * rs.uniform(0.8, 1.25, gt.shape)).astype(np.float32)
    pred[1, :2] = -1.0  # non-positive predictions trigger the clip branches
    mask = rs.rand(*gt.shape) > 0.3
    fxb = rs.uniform(5.0, 40.0, (3,)).astype(np.float32)
    return gt, pred, mask, fxb


@pytest.mark.parametrize("space", ["disp", "depth"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("with_fxb", [True, False])
def test_compute_errors_matches_jax(space, masked, with_fxb):
    gt, pred, mask, fxb = _case(3, space)
    if not masked:
        gt[0, 0, 0] = 0.0  # the default mask drops zeros
    ref = jax_errors(jnp.asarray(gt), jnp.asarray(pred), space,
                     jnp.asarray(mask) if masked else None,
                     jnp.asarray(fxb) if with_fxb else None)
    ours = compute_errors(torch.from_numpy(gt), torch.from_numpy(pred), space,
                          torch.from_numpy(mask) if masked else None,
                          torch.from_numpy(fxb) if with_fxb else None)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        for col in range(r.shape[1]):
            np.testing.assert_allclose(o.numpy()[:, col], r[:, col], rtol=0,
                                       atol=1e-6 * max(np.abs(r[:, col]).max(), 1.0))
    d_ours, d_ref = metrics_to_dict(*ours), jax_to_dict(*ref)
    assert {k: list(v) for k, v in d_ours.items()} == {k: list(v) for k, v in d_ref.items()}


@pytest.mark.parametrize("reduction", ["median", "mean"])
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
def test_ensemble_depths_matches_jax(rounds, reduction):
    rs = np.random.RandomState(rounds)
    base = rs.rand(12, 16).astype(np.float32)
    x = np.stack([base * rs.uniform(0.5, 2) + rs.uniform(-1, 1) + 0.05 * rs.randn(12, 16)
                  for _ in range(rounds)]).astype(np.float32)
    ref = jax_ensemble(jnp.asarray(x), reduction=reduction)
    ours = ensemble_depths(torch.from_numpy(x), reduction=reduction)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_ensemble_median_of_an_even_count_is_the_midpoint():
    x = torch.tensor([[[0.0]], [[1.0]], [[3.0]], [[10.0]]])
    from d3roma_tpu_torch.ops.ensemble import _median0

    assert _median0(x).item() == 2.0 and torch.median(x, dim=0).values.item() == 1.0


@pytest.mark.parametrize("hw,divis", [((36, 64), 8), ((30, 50), 8), ((32, 64), 32), ((7, 9), 4)])
def test_input_padder_matches_jax(hw, divis):
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32)
    for mode in ("sintel", "other"):
        ours, ref = InputPadder(x.shape, mode=mode, divis_by=divis), JaxPadder(
            x.shape, mode=mode, divis_by=divis)
        assert ours.padded_size == ref.padded_size
        (p,), (pr,) = ours.pad(torch.from_numpy(x)), ref.pad(jnp.asarray(x))
        assert np.array_equal(p.numpy(), np.asarray(pr))
        (z,), (zr,) = ours.pad_zero(torch.from_numpy(x)), ref.pad_zero(jnp.asarray(x))
        assert np.array_equal(z.numpy(), np.asarray(zr))
        assert torch.equal(ours.unpad(p), torch.from_numpy(x))
        assert ours.pad(None) == [None]


def test_running_averager_rejects_as_jax():
    rs = np.random.RandomState(1)
    ours, ref = (cls(detect_anomaly={"epe": 10.0}) for cls in (RunningAverager, JaxAverager))
    for i in range(12):
        sample = {"epe": float(rs.uniform(0.5, 1.5)) * (30.0 if i in (6, 9) else 1.0),
                  "rel": float(rs.rand())}
        assert ours.append(sample, index=(i, 0)) == ref.append(sample, index=(i, 0))
    assert ours.num_rejected == ref.num_rejected == 2
    assert ours.abnormal_indexes == ref.abnormal_indexes == [(6, 0), (9, 0)]
    assert ours.average() == ref.average() and ours.recent_average() == ref.recent_average()
    assert len(ours) == len(ref)


def test_intermediate_metrics_match_jax():
    rs = np.random.RandomState(2)
    inter = rs.uniform(0.0, 20.0, (3, 2, 8, 10, 1)).astype(np.float32)
    gt = rs.uniform(1.0, 20.0, (2, 8, 10, 1)).astype(np.float32)
    mask = (rs.rand(2, 8, 10, 1) > 0.2).astype(np.float32)
    fxb = np.array([10.0, 20.0], np.float32)
    cfg = TrainingConfig(prediction_space="disp")
    ref = jax_intermediate(cfg, jnp.asarray(fxb), jnp.asarray(inter), jnp.asarray(gt),
                           jnp.asarray(mask), dataset_name="HISS")
    ours = evaluate_intermediate_metrics(cfg, torch.from_numpy(fxb), torch.from_numpy(inter),
                                         torch.from_numpy(gt), torch.from_numpy(mask),
                                         dataset_name="HISS")
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("name", ["Spectral", "jet", "magma"])
def test_colour_tables_equal_matplotlib(name):
    cmap = plt.get_cmap(name)
    x = np.linspace(0, 1, 1001, dtype=np.float32)
    ref = (cmap(x)[..., :3] * 255).astype(np.uint8)
    assert np.array_equal(colormaps.byte_table(name)[np.minimum((x * 256).astype(int), 255)],
                          ref)
    assert np.array_equal(viz._apply(colormaps.byte_table(name), x), ref)


def test_figures_are_the_pixels_matplotlib_colours(tmp_path):
    rs = np.random.RandomState(4)
    d = (rs.rand(18, 32) * 5).astype(np.float32)
    assert np.array_equal(viz.colorize(d), jax_viz.colorize(d))
    assert np.array_equal(viz.colorize(d, "jet", 1.0, 3.0), jax_viz.colorize(d, jax_viz.CMAP_JET,
                                                                             1.0, 3.0))
    viz.save_colorized(str(tmp_path / "c.png"), d)
    assert np.array_equal(png.read_png(str(tmp_path / "c.png")), jax_viz.colorize(d))

    def imshow(data, cmap, vmax=None):
        norm = Normalize(vmin=None, vmax=vmax)
        norm.autoscale_None(np.ma.masked_invalid(data))
        return plt.get_cmap(cmap)(norm(data), bytes=True)[..., :3]

    gt = rs.rand(18, 32).astype(np.float32) * 4
    viz.plot_error_map(gt, d, None, str(tmp_path / "e.png"))
    assert np.array_equal(png.read_png(str(tmp_path / "e.png")), imshow(np.abs(gt - d), "jet"))
    viz.plot_error_map(gt, d, None, str(tmp_path / "e2.png"), vmax=1.0)
    assert np.array_equal(png.read_png(str(tmp_path / "e2.png")),
                          imshow(np.abs(gt - d), "jet", 1.0))
    viz.plot_uncertainties(d, str(tmp_path / "u.png"))
    assert np.array_equal(png.read_png(str(tmp_path / "u.png")), imshow(d, "magma"))
    steps = [d * (k + 1) - k for k in range(5)]
    viz.plot_denoised_images(steps, str(tmp_path / "g.png"))
    grid = png.read_png(str(tmp_path / "g.png"))
    assert grid.shape == (36, 128, 3)
    assert np.array_equal(grid, jax_viz.make_image_grid([imshow(s, "Spectral") for s in steps],
                                                        2, 4))
    # the line charts are drawn since they were ported (tests/test_torch_viz_plots.py)
    viz.plot_intermediate_metrics({"epe": [1.0, 0.5]}, str(tmp_path / "m.png"))
    assert png.read_png(str(tmp_path / "m.png")).shape == (240, 320, 3)
    viz.plot_intermediate_metrics({}, str(tmp_path / "none.png"))
    assert not (tmp_path / "none.png").exists()
