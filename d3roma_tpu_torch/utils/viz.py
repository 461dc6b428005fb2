"""Eval artifacts as colour-mapped images, without matplotlib.

Port of `d3roma_tpu/utils/viz.py`. The machine with the card has no
matplotlib, so each figure is written as the pixels matplotlib's colour
map gives the data (`utils/colormaps.py`, the same 256-entry tables,
bit-equal), through `utils/png.py`:

- `colorize` / `save_colorized`: the JAX package's own contract (min/max
  or the given window, clipped), the same bytes;
- `plot_error_map`, `plot_uncertainties`, `plot_denoised_images`: the
  colour-mapped pixels `imshow` would draw at the data's resolution, with
  its default min/max normalisation (and `vmax` where given); the
  denoised steps tiled by `make_image_grid`. They draw no axes, titles or
  colorbar, and no figure margins: that is the deviation from the JAX
  package's figures (README.md).

`plot_intermediate_metrics` and `plot_loss_terms` are line charts; they
raise NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from d3roma_tpu_torch.utils.colormaps import byte_table
from d3roma_tpu_torch.utils.png import write_png

def _apply(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The colour map on normalized float32 values, as matplotlib's
    `Colormap.__call__` indexes it: int(v * N) (v == 1 -> N - 1), under
    and over to the end colours (matplotlib's defaults), NaN black (the
    transparent "bad" colour with its alpha dropped)."""
    n = len(table)
    xa = np.asarray(v, np.float32) * np.float32(n)
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), -1, n).astype(np.int64)
    idx = np.clip(idx, 0, n - 1)
    out = table[idx]
    out[bad] = 0
    return out


def colorize(x: np.ndarray, cmap: str = "Spectral", vmin=None, vmax=None) -> np.ndarray:
    """Scalar map [H,W] -> uint8 RGB via a colormap (the Spectral pred.png
    contract — reference: inference.py:307-311)."""
    x = np.asarray(x, np.float32)
    vmin = np.nanmin(x) if vmin is None else vmin
    vmax = np.nanmax(x) if vmax is None else vmax
    nx = (x - vmin) / max(vmax - vmin, 1e-12)
    return _apply(byte_table(cmap), np.clip(nx, 0, 1))


def save_colorized(path: str, x: np.ndarray, cmap: str = "Spectral", vmin=None, vmax=None):
    write_png(path, colorize(x, cmap, vmin, vmax))


def _imshow_pixels(data: np.ndarray, cmap: str, vmin=None, vmax=None) -> np.ndarray:
    """The pixels `imshow(data, cmap=cmap, vmin=vmin, vmax=vmax)` colours:
    matplotlib's Normalize (float32 data, autoscaled to its finite min
    and max where a limit is None; all zero when they are equal)."""
    data = np.asarray(data, np.float32)
    finite = data[np.isfinite(data)]
    lo = float(vmin) if vmin is not None else float(finite.min()) if finite.size else 0.0
    hi = float(vmax) if vmax is not None else float(finite.max()) if finite.size else 0.0
    if lo == hi:
        v = np.zeros_like(data)
    else:
        v = (data - np.float32(lo)) / np.float32(hi - lo)
    return _apply(byte_table(cmap), v)


def plot_error_map(
    gt: np.ndarray, pred: np.ndarray, mask: Optional[np.ndarray], path: str,
    vmax: Optional[float] = None,
) -> None:
    """|gt - pred| over the mask as a jet map (reference: camera.py:782-800)."""
    err = np.abs(np.asarray(gt, np.float32) - np.asarray(pred, np.float32))
    if mask is not None:
        err = err * np.asarray(mask, np.float32)
    write_png(path, _imshow_pixels(err, "jet", vmax=vmax))


def plot_uncertainties(unc: np.ndarray, path: str) -> None:
    """Multi-round sigma map (reference: camera.py:815-838)."""
    write_png(path, _imshow_pixels(np.asarray(unc, np.float32), "magma"))


def plot_loss_terms(curves: Dict[str, Sequence[float]], path: str) -> None:
    """Per-timestep loss/weight curves: a line chart, not ported."""
    raise NotImplementedError("plot_loss_terms draws a line chart; not ported (ROADMAP.md)")


def plot_denoised_images(
    images: Sequence[np.ndarray], path: str, ncols: int = 4, cmap: str = "Spectral"
) -> None:
    """Grid of intermediate x_hat0 frames (reference: camera.py:840-900),
    each colour-mapped over its own min and max, tiled row by row."""
    n = len(images)
    if n == 0:
        return
    ncols = min(ncols, max(1, n))
    nrows = (n + ncols - 1) // ncols
    tiles = [_imshow_pixels(np.asarray(im, np.float32).squeeze(), cmap) for im in images]
    write_png(path, make_image_grid(tiles, nrows, ncols))


def make_image_grid(
    images: List[np.ndarray], rows: int, cols: int
) -> np.ndarray:
    """Tile uint8 RGB images into one canvas (reference: camera.py:959-1017)."""
    assert len(images) <= rows * cols
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        r, c = divmod(i, cols)
        canvas[r * h: r * h + im.shape[0], c * w: c * w + im.shape[1]] = im[..., :3]
    return canvas


def plot_intermediate_metrics(
    metric_curves: Dict[str, Sequence[float]], path: str
) -> None:
    """Metric-vs-denoise-step curves: a line chart, not ported."""
    raise NotImplementedError(
        "plot_intermediate_metrics draws a line chart; not ported (ROADMAP.md)")
