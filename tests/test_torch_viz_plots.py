"""The two line charts of `d3roma_tpu_torch/utils/viz.py`, which the JAX
package draws with matplotlib:

- `plot_intermediate_metrics` from the evaluation loop: both packages'
  `evaluate_dataset` under the `eval_his_sim` preset with
  `plot_intermediate_metrics` on (its least-squares SSI alignment, not
  the RANSAC one, whose subsets each package draws from its own
  generator), on four procedural HISS frames (36x64, two batches) with a
  deterministic stand-in pipeline whose two intermediates are the square
  of its sim_disp input (no affine map fixes it) and the input itself; the
  metric dicts handed to the plot (the JAX side's captured by
  monkeypatching `d3roma_tpu.utils.viz.plot_intermediate_metrics`, the
  port's by wrapping its own) hold the same metrics and curves, within
  1e-5 relative (a float32 least-squares alignment, then float32 masked
  means, each summed in another order: measured 3.8e-6), and the port wrote
  the figure of each batch;
- the figure itself: one 320x240 panel per metric, the axes' frame, every
  finite point of a curve at the pixel the documented mapping gives
  (matplotlib's 5% margins inside the plot inset), in the colour cycle's
  first colour, segments between neighbours, none across a NaN; an
  empty dict writes nothing;
- `plot_loss_terms`: one 640x400 panel, the curves on shared limits in the
  cycle's first colours."""

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.config import load_task_preset as jax_preset
from d3roma_tpu.data import fetch_dataloader as jax_fetch
from d3roma_tpu.evaluation import evaluate_dataset as jax_evaluate
from d3roma_tpu.guidance import FlowGuidance as JaxGuidance
from d3roma_tpu.ops import Normalizer as JaxNormalizer
from d3roma_tpu.training.train_loop import _preprocess_eval
from d3roma_tpu.utils import viz as jax_viz
from d3roma_tpu_torch.config import load_task_preset
from d3roma_tpu_torch.data import preprocess_eval, val_loaders
from d3roma_tpu_torch.evaluation import evaluate_dataset
from d3roma_tpu_torch.guidance import FlowGuidance
from d3roma_tpu_torch.ops.normalizer import Normalizer
from d3roma_tpu_torch.pipelines import PipelineOutput
from d3roma_tpu_torch.synthetic import SceneConfig, generate_dataset
from d3roma_tpu_torch.utils import png, viz

FRAMES, BATCH = 4, 2
# safe_ssi off: the preset's RANSAC draws its subsets from each package's
# own generator; the plain least-squares alignment is deterministic
OVERRIDES = dict(eval_dataset=["HISS"], camera_resolution="64x36", eval_batch_size=BATCH,
                 plot_intermediate_metrics=True, safe_ssi=False)
C0, C1 = viz.COLOR_CYCLE[0], viz.COLOR_CYCLE[1]


@dataclasses.dataclass
class _JaxStandIn:
    guidance: JaxGuidance = JaxGuidance(flow_guidance_weight=0.0)
    vae: object = None

    class Out(NamedTuple):
        images: jnp.ndarray
        intermediates: jnp.ndarray

    def __call__(self, key, **kw):
        d = kw["sim_disp"]
        return self.Out(d, jnp.stack([d * d, d]))


@dataclasses.dataclass
class _PortStandIn:
    guidance: FlowGuidance = FlowGuidance(flow_guidance_weight=0.0)
    vae: object = None
    device: str = "cpu"

    def __call__(self, generator=None, **kw):
        d = kw["sim_disp"]
        return PipelineOutput(d, torch.stack([d * d, d]))


def _configs():
    out = []
    for load in (jax_preset, load_task_preset):
        cfg = load("eval_his_sim")
        for k, v in OVERRIDES.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _recorder(fn, calls):
    def record(curves, path):
        calls.append(({k: v.numpy() if isinstance(v, torch.Tensor) else np.array(v)
                       for k, v in curves.items()}, path))
        return fn(curves, path)

    return record


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz_plots")
    generate_dataset(str(root / "datasets" / "HISS"), FRAMES, split="test",
                     config=SceneConfig(height=36, width=64), seed=11)
    mp = pytest.MonkeyPatch()
    mp.chdir(root)
    jax_calls, port_calls = [], []
    mp.setattr(jax_viz, "plot_intermediate_metrics",
               _recorder(lambda curves, path: None, jax_calls))
    mp.setattr(viz, "plot_intermediate_metrics",
               _recorder(viz.plot_intermediate_metrics, port_calls))
    try:
        jcfg, pcfg = _configs()
        jax_evaluate(jcfg, _JaxStandIn(), jax_fetch(jcfg)[1][0], jnp.zeros(2, jnp.uint32),
                     eval_output_dir=str(root / "jax_art"), write_artifacts=True,
                     dataset_name="HISS",
                     preprocess=partial(_preprocess_eval, config=jcfg,
                                        normalizer=JaxNormalizer.from_config(jcfg)))
        evaluate_dataset(pcfg, _PortStandIn(), val_loaders(pcfg)[0],
                         torch.Generator().manual_seed(0),
                         eval_output_dir=str(root / "port_art"), write_artifacts=True,
                         dataset_name="HISS",
                         preprocess=partial(preprocess_eval, config=pcfg,
                                            normalizer=Normalizer.from_config(pcfg),
                                            device="cpu"))
    finally:
        mp.undo()
    return root, jax_calls, port_calls


def test_intermediate_curves_match_the_jax_eval(curves):
    root, jax_calls, port_calls = curves
    assert len(port_calls) == len(jax_calls) == FRAMES // BATCH
    for (ours, path), (ref, ref_path) in zip(port_calls, jax_calls):
        assert os.path.basename(path) == os.path.basename(ref_path)
        assert list(ours) == list(ref) == ["epe", "rel"]
        for k in ref:
            assert ours[k].shape == ref[k].shape == (2,), k
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=0, err_msg=k)
        assert ref["epe"][0] > ref["epe"][1] >= 0  # the squared disparity is the worse step
    for i in range(FRAMES // BATCH):
        assert png.read_png(str(root / "port_art" / f"idx{i}_intermediate_metrics.png")).shape \
            == (240, 640, 3)


def _expected(curves, hw):
    """(row, col) of every finite point, by the documented mapping: x = the
    point's index, both limits the data's widened by 5% of their span (a
    flat range by 0.5), onto the plot inset of the panel."""
    top, left, bottom, right = viz.PLOT_INSET
    h, w = hw
    xs = np.concatenate([np.flatnonzero(np.isfinite(c)) for c in curves]).astype(float)
    ys = np.concatenate([c[np.isfinite(c)] for c in curves])

    def lim(v):
        lo, hi = v.min(), v.max()
        return (lo - 0.5, hi + 0.5) if hi == lo else (lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo))

    (xl, xh), (yl, yh) = lim(xs), lim(ys)
    out = []
    for c in curves:
        i = np.flatnonzero(np.isfinite(c))
        cols = np.rint(left + (i - xl) / (xh - xl) * (w - 1 - right - left)).astype(int)
        rows = np.rint(h - 1 - bottom - (c[i] - yl) / (yh - yl) * (h - 1 - bottom - top))
        out.append(np.stack([rows.astype(int), cols], axis=1))
    return out


def test_intermediate_figure_draws_every_point(curves, tmp_path):
    _, _, port_calls = curves
    metrics, path = port_calls[0]
    img = png.read_png(path)
    for k, name in enumerate(metrics):
        (pts,) = _expected([metrics[name].astype(np.float64)], (240, 320))
        for r, c in pts:
            assert np.array_equal(img[r, c + 320 * k], C0), (name, r, c)
    top, left, bottom, right = viz.PLOT_INSET
    assert (img[top - 1, left - 1: 320 - right + 1] == 0).all()  # the frame
    assert (img[0, :] == 255).all()  # white outside it
    # a NaN breaks the line: the midpoint between its neighbours stays white
    curve = np.array([1.0, 3.0, np.nan, 2.0, 0.0])
    viz.plot_intermediate_metrics({"epe": curve}, str(tmp_path / "nan.png"))
    img = png.read_png(str(tmp_path / "nan.png"))
    (pts,) = _expected([curve], (240, 320))
    for r, c in pts:
        assert np.array_equal(img[r, c], C0)
    mid = (pts[1] + pts[2]) // 2
    assert (img[mid[0], mid[1]] == 255).all()
    mid = (pts[2] + pts[3]) // 2  # the segment from x = 3 to 4 is drawn
    assert np.array_equal(img[mid[0], mid[1]], C0)
    viz.plot_intermediate_metrics({}, str(tmp_path / "empty.png"))
    assert not (tmp_path / "empty.png").exists()


def test_loss_terms_share_limits_and_cycle_colours(tmp_path):
    a = np.array([4.0, 2.0, 1.0, 0.5])
    b = np.array([0.2, 0.3, 3.0, 3.5, 3.6, 3.0])
    viz.plot_loss_terms({"loss": a, "weight": torch.from_numpy(b)}, str(tmp_path / "l.png"))
    img = png.read_png(str(tmp_path / "l.png"))
    assert img.shape == (400, 640, 3)
    pa, pb = _expected([a, b], (400, 640))
    for r, c in pb:  # drawn last, on top
        assert np.array_equal(img[r, c], C1)
    for r, c in pa:
        assert np.array_equal(img[r, c], C0) or np.array_equal(img[r, c], C1)
    assert (img == C0).all(-1).sum() > 100 and (img == C1).all(-1).sum() > 100
