"""Block-matching stereo ("sim depth" generator), NHWC.

Port of `d3roma_tpu/ops/stereo.py` (reference: scripts/stereo_matching.py:
90-320, adapted there from DREDS): zero-mean NCC block matching over a
disparity cost volume, soft-argmax with parabolic sub-pixel refinement, a
left-right consistency check and a median filter. The JAX package vmaps
its per-disparity correlation over D; here the disparities go through in
chunks of the D axis, each chunk one set of batched torch ops, so that a
call launches a few hundred kernels, not D times as many.

Precision. The variance terms `L2s - 2*La*Ls + n*La*La` cancel: each box
sum must be true fp32. They are sums of k-wide windows along W, then along
H (`Tensor.unfold(...).sum(-1)`): no convolution, so neither cuDNN's TF32
nor an average's division and re-multiplication touches them. The sums run
in another order than XLA's `reduce_window`, which is the one difference
from the JAX arithmetic; every other expression keeps its operands and its
order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from d3roma_tpu_torch.ops.warp import bilinear_sample

# elements of one [d, B, H, W, C] chunk temporary: at most 256 MiB in fp32
_CHUNK_ELEMS = 1 << 26


def _window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sum over k-wide windows along `dim`, zero padded as XLA's SAME."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    pad = [0, 0] * (x.dim() - 1 - dim) + [lo, hi]
    xp = torch.nn.functional.pad(x, pad)
    return xp.unfold(dim, k, 1).sum(-1)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over k x k windows (SAME padding), summed over channels.
    x: [B,H,W,C] -> [B,H,W,1]."""
    s = torch.sum(x, dim=-1, keepdim=True)
    return _window_sum(_window_sum(s, k, 2), k, 1)


def _shift(x: torch.Tensor, ds: torch.Tensor, right: bool) -> torch.Tensor:
    """x [B,H,W,C] shifted along W by each of `ds` [d]: `roll(x, i)` times
    the (w >= i) mask when `right`, `roll(x, -i)` times (w < W - i) if not,
    as the JAX package's shift_right / shift_left. Returns [B,H,d,W,C]."""
    B, H, W, C = x.shape
    w = torch.arange(W, device=x.device)
    if right:
        src, keep = (w[None, :] - ds[:, None]) % W, w[None, :] >= ds[:, None]
    else:
        src, keep = (w[None, :] + ds[:, None]) % W, w[None, :] < W - ds[:, None]
    out = x.index_select(2, src.reshape(-1)).reshape(B, H, len(ds), W, C)
    return out * keep.to(x.dtype)[None, None, :, :, None]


def _corr_chunk(X, Xs, Xa, Y, Ys, Ya, Y2s, var_x, ds, k, n, eps, right):
    """NCC of X(x) against Y shifted by each of `ds` (right: Y(x - i), else
    Y(x + i)), the JAX corr_at's left or right half. Returns [d,B,H,W]."""
    sY = _shift(Y, ds, right)
    sYs, sY2s, sYa = (_shift(t, ds, right)[..., 0] for t in (Ys, Y2s, Ya))
    Xs, Xa = Xs[:, :, None, :, 0], Xa[:, :, None, :, 0]
    box = _window_sum(_window_sum(torch.sum(X[:, :, None] * sY, dim=-1), k, 3), k, 1)
    prod = box - Xa * sYs - sYa * Xs + n * Xa * sYa
    var_s = sY2s - 2 * sYa * sYs + n * sYa * sYa + 1e-5
    corr = (prod + eps) / (torch.sqrt(var_x[:, :, None, :, 0])
                           * torch.sqrt(torch.clamp(var_s, min=1e-10)) + eps)
    W = X.shape[2]
    w = torch.arange(W, device=X.device)
    keep = (w[None, :] >= ds[:, None]) if right else (w[None, :] < W - ds[:, None])
    corr = corr * keep.to(corr.dtype)[None, None]
    return corr.permute(2, 0, 1, 3)


def ncc_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    min_disp: int,
    max_disp: int,
    block_size: int = 11,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-mean NCC cost volumes for left and right views.

    left/right: [B,H,W,C] float in [0,1]. Returns (costL, costR), each
    [D,B,H,W] where D = max_disp - min_disp + 1. Matches the reference's
    CorrL/CorrR box-filtered formulation (stereo_matching.py:96-159).
    """
    k = block_size
    n = k * k * left.shape[-1]
    left, right = left.float(), right.float()

    def cache(img):
        s = _box_sum(img, k)
        ave = s / n
        s2 = _box_sum(img * img, k)
        return img, s, ave, s2

    L, Ls, La, L2s = cache(left)
    R, Rs, Ra, R2s = cache(right)

    var_l = L2s - 2 * La * Ls + n * La * La + 1e-5
    var_r = R2s - 2 * Ra * Rs + n * Ra * Ra + 1e-5

    B, H, W, C = left.shape
    D = max_disp - min_disp + 1
    costL = torch.empty((D, B, H, W), dtype=torch.float32, device=left.device)
    costR = torch.empty_like(costL)
    step = max(1, _CHUNK_ELEMS // max(1, B * H * W * C))
    disps = torch.arange(min_disp, max_disp + 1, device=left.device)
    for d0 in range(0, D, step):
        ds = disps[d0:d0 + step]
        # left view: compare L(x) with R(x - i); right view: R(x) with L(x + i)
        costL[d0:d0 + step] = _corr_chunk(L, Ls, La, R, Rs, Ra, R2s, var_l, ds, k, n, eps, True)
        costR[d0:d0 + step] = _corr_chunk(R, Rs, Ra, L, Ls, La, L2s, var_r, ds, k, n, eps, False)
    return costL, costR


def soft_argmax_disp(
    cost: torch.Tensor,
    min_disp: int,
    max_disp: int,
    beta: float = 100.0,
    eps: float = 1e-6,
    sub_pixel: bool = True,
) -> torch.Tensor:
    """Cost volume [D,B,H,W] -> disparity [B,H,W] via temperature-softmax
    expectation, with parabolic sub-pixel refinement
    (reference: scripts/stereo_matching.py:235-249)."""
    D = cost.shape[0]
    disp_vol = torch.arange(min_disp, max_disp + 1, dtype=cost.dtype,
                            device=cost.device).reshape(D, 1, 1, 1)
    if sub_pixel:
        zeros = torch.zeros_like(cost[:1])
        prev = torch.cat([zeros, cost[: D - 1]], dim=0)
        nxt = torch.cat([cost[1:], zeros], dim=0)
        disp_vol = disp_vol + (prev - nxt + eps) / (2 * (prev + nxt - 2 * cost) + eps)
    attn = torch.softmax(cost * beta, dim=0)
    return torch.sum(attn * disp_vol, dim=0)


def lrc_check(dispL: torch.Tensor, dispR: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Left-right consistency: warp the right disparity into the left view
    and invalidate (-1) inconsistent pixels
    (reference: scripts/stereo_matching.py:192-202). The SQUARED difference
    is compared with the raw threshold, as the reference writes it: the
    pixel tolerance is sqrt(threshold), ~0.71 px."""
    B, H, W = dispL.shape
    xs = torch.arange(W, dtype=dispL.dtype, device=dispL.device)[None, None, :]
    ys = torch.arange(H, dtype=dispL.dtype, device=dispL.device)[None, :, None]
    warped_r = bilinear_sample(dispR[..., None], xs.expand(B, H, W) - dispL,
                               ys.expand(B, H, W))[..., 0]
    return torch.where((dispL - warped_r) ** 2 > threshold,
                       torch.full_like(dispL, -1.0), dispL)


def _views(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """The k*k shifted views of x [B,H,W] under `mode` padding, [B,H,W,k*k]
    in row-major window order."""
    p = (k - 1) // 2
    xp = torch.nn.functional.pad(x[:, None], (p, k - 1 - p, p, k - 1 - p), mode=mode)[:, 0]
    return xp.unfold(1, k, 1).unfold(2, k, 1).reshape(x.shape + (k * k,))


def median_blur(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k median filter with edge padding, [B,H,W] (the reference's
    kornia median_blur, stereo_matching.py:451-454). k odd: the middle of
    the k*k sorted values, which is jnp.median's value."""
    if k % 2 == 0:
        raise ValueError(f"median_blur takes an odd window, got {k}")
    return torch.median(_views(x, k, "replicate"), dim=-1).values


class StereoMatchOutput(NamedTuple):
    disp: torch.Tensor  # [B,H,W], -1 where invalid
    valid: torch.Tensor  # [B,H,W] bool
    depth: torch.Tensor  # [B,H,W], 0 where invalid


@torch.no_grad()
def stereo_match(
    left: torch.Tensor,
    right: torch.Tensor,
    fxb: float,
    min_disp: int = 10,
    max_disp: int = 110,
    block_size: int = 11,
    beta: float = 100.0,
    eps: float = 1e-6,
    sub_pixel: bool = True,
    use_median: bool = True,
    lrc_threshold: float = 0.5,
) -> StereoMatchOutput:
    """Full pipeline: NCC cost volumes -> soft-argmax disparities -> LRC ->
    median filter -> depth (reference: StereoMatching.forward,
    scripts/stereo_matching.py:360-475; defaults fx*b and maxDisp=110,
    block=11 from :521-536,604-605).

    left/right: [B,H,W,C] float in [0,1] (grayscale IR tiled to C=1 or 3),
    on the device the match runs on.
    """
    costL, costR = ncc_cost_volume(left, right, min_disp, max_disp, block_size, eps)
    dispL = soft_argmax_disp(costL, min_disp, max_disp, beta, eps, sub_pixel)
    del costL
    dispR = soft_argmax_disp(costR, min_disp, max_disp, beta, eps, sub_pixel)
    del costR
    disp = lrc_check(dispL, dispR, lrc_threshold)
    if use_median:
        disp = median_blur(disp, 5)
    disp = torch.where((disp < min_disp) | (disp > max_disp), torch.full_like(disp, -1.0), disp)
    valid = disp > 0
    depth = torch.where(valid, fxb / torch.clamp(disp, min=eps), torch.zeros_like(disp))
    return StereoMatchOutput(disp, valid, depth)


def bilateral_filter(
    x: torch.Tensor, ksize: int = 5,
    sigma_color: float | None = None, sigma_space: float | None = None,
) -> torch.Tensor:
    """Edge-preserving bilateral filter, [B,H,W]
    (reference: scripts/stereo_matching.py:29-57: gaussian spatial kernel x
    per-patch color-difference kernel, reflect padding)."""
    if sigma_space is None:
        sigma_space = 0.15 * ksize + 0.35
    if sigma_color is None:
        sigma_color = sigma_space
    views = _views(x, ksize, "reflect")  # [B,H,W,k*k]
    diff = views - x[..., None]
    w_color = torch.exp(-(diff ** 2) / (2 * sigma_color ** 2))
    w_color = w_color / torch.sum(w_color, dim=-1, keepdim=True)

    ax = torch.arange(ksize, dtype=x.dtype, device=x.device) - (ksize - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2 * sigma_space ** 2))
    w_space = (g[:, None] * g[None, :]).reshape(-1)
    w_space = w_space / torch.sum(w_space)

    w = w_color * w_space
    return torch.sum(w * views, dim=-1) / torch.sum(w, dim=-1)
