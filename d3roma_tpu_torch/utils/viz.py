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
  package's figures (README.md);
- `plot_intermediate_metrics` (one panel per metric, as the JAX figure's
  subplots) and `plot_loss_terms` (one panel, one line per curve) are line
  charts drawn by `line_chart`: each panel the JAX figure's size at 80
  dots an inch, a white ground, the axes' frame, every curve's finite
  points joined by straight segments and marked with a 3x3 dot, in
  matplotlib's default colour cycle; the limits are the data's with
  matplotlib's 5% margins. They draw no ticks, labels, titles or legend
  (there is no font), the same deviation.
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


# matplotlib's default colour cycle ("tab10"), as RGB bytes
COLOR_CYCLE = np.array([[0x1f, 0x77, 0xb4], [0xff, 0x7f, 0x0e], [0x2c, 0xa0, 0x2c],
                        [0xd6, 0x27, 0x28], [0x94, 0x67, 0xbd], [0x8c, 0x56, 0x4b],
                        [0xe3, 0x77, 0xc2], [0x7f, 0x7f, 0x7f], [0xbc, 0xbd, 0x22],
                        [0x17, 0xbe, 0xcf]], np.uint8)
DPI = 80
# the plot area inside a panel, in pixels from its edges: top, left, bottom, right
PLOT_INSET = (12, 16, 12, 12)
MARGIN = 0.05  # matplotlib's axes.xmargin and axes.ymargin


def _host_values(ys) -> np.ndarray:
    """A curve as float64 numpy (a tensor on any device, a list, an array)."""
    if hasattr(ys, "detach"):
        ys = ys.detach().float().cpu().numpy()
    return np.asarray(ys, np.float64).reshape(-1)


def _limits(v: np.ndarray):
    """matplotlib's autoscaled limits with its 5% margins; a flat or
    empty range is widened to +-0.5 about its value."""
    if v.size == 0:
        return -0.5, 0.5
    lo, hi = float(v.min()), float(v.max())
    if hi - lo <= 1e-12 * max(1.0, abs(lo), abs(hi)):
        return lo - 0.5, hi + 0.5
    pad = MARGIN * (hi - lo)
    return lo - pad, hi + pad


def _panel_limits(curves):
    xs = np.concatenate([np.arange(len(v), dtype=np.float64)[np.isfinite(v)] for v in curves]
                        or [np.zeros(0)])
    vs = np.concatenate([v[np.isfinite(v)] for v in curves] or [np.zeros(0)])
    return _limits(xs), _limits(vs)


def _positions(v: np.ndarray, limits, hw) -> np.ndarray:
    (x_lo, x_hi), (y_lo, y_hi) = limits
    top, left, bottom, right = PLOT_INSET
    h, w = hw
    r0, r1 = top, h - 1 - bottom
    c0, c1 = left, w - 1 - right
    x = np.arange(len(v), dtype=np.float64)
    out = np.full((len(v), 2), -1, np.int64)
    ok = np.isfinite(v)
    out[ok, 1] = np.rint(c0 + (x[ok] - x_lo) / (x_hi - x_lo) * (c1 - c0))
    out[ok, 0] = np.rint(r1 - (v[ok] - y_lo) / (y_hi - y_lo) * (r1 - r0))
    return out


def _draw_panel(curves: Sequence[np.ndarray], hw) -> np.ndarray:
    h, w = hw
    img = np.full((h, w, 3), 255, np.uint8)
    top, left, bottom, right = PLOT_INSET
    img[top - 1, left - 1: w - right + 1] = 0  # the axes' frame, outside the plot area
    img[h - bottom, left - 1: w - right + 1] = 0
    img[top - 1: h - bottom + 1, left - 1] = 0
    img[top - 1: h - bottom + 1, w - right] = 0
    limits = _panel_limits(curves)
    for k, v in enumerate(curves):
        color = COLOR_CYCLE[k % len(COLOR_CYCLE)]
        pos = _positions(v, limits, hw)
        finite = np.flatnonzero(pos[:, 0] >= 0)
        for a, b in zip(finite[:-1], finite[1:]):
            if b != a + 1:
                continue  # a non-finite value breaks the line, as in matplotlib
            n = int(np.abs(pos[b] - pos[a]).max()) + 1
            t = np.linspace(0.0, 1.0, n)[:, None]
            seg = np.rint(pos[a] + t * (pos[b] - pos[a])).astype(np.int64)
            img[seg[:, 0], seg[:, 1]] = color
        for r, c in pos[finite]:
            img[max(r - 1, 0): r + 2, max(c - 1, 0): c + 2] = color
    return img


def line_chart(panels: Sequence[Sequence], panel_hw) -> np.ndarray:
    """Panels side by side, each a list of curves: uint8 RGB [H, W * n, 3]."""
    return np.concatenate(
        [_draw_panel([_host_values(ys) for ys in curves], panel_hw) for curves in panels],
        axis=1)


def plot_loss_terms(curves: Dict[str, Sequence[float]], path: str) -> None:
    """Per-timestep loss/weight curves, one line each in one panel of the
    JAX figure's 8x5 inches (reference: camera.py:802-812)."""
    write_png(path, line_chart([list(curves.values())], (5 * DPI, 8 * DPI)))


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
    """Metric-vs-denoise-step curves, one panel of 4x3 inches per metric
    (reference: evaluate.py:263-295); nothing for an empty dict."""
    if not metric_curves:
        return
    write_png(path, line_chart([[ys] for ys in metric_curves.values()], (3 * DPI, 4 * DPI)))
