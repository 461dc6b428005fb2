"""The host plan of the CUDA Winograd conv (ops/kernels/winograd.py::
wino_plan) and a plain-torch model of the kernel's decomposition
(csrc/winograd_fused.cu), on the CPU: the input transform into V [16, Mt, C],
the 128-tile x 64-channel block tiles in the kernel's order, the per-tap fold
of M_t into the four output accumulators, the split of the taps, and the
edge masks at odd H and W; the model against the JAX fused Pallas kernel in
interpret mode, and the plan's tiles, splits and TMA maps at the flagship
shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d3roma_tpu.ops.pallas.winograd_fused import conv3x3_wino_fused
from d3roma_tpu_torch.ops.kernels import winograd as pw
from torch_port_utils import randn

SMS = 132
# bf16 output: the model sums the taps in another fp32 order than the TPU
# kernel (and than the plain version), so a value may round to the
# neighbouring bf16: one bf16 ulp, at most 2^-7 of the value
BF16_ULP = 2.0 ** -7
# with a bias added after the rounding, as the chip check holds the kernel
# to its plain version: 1e-2 x max |ref|
REL_TOL = 1e-2


def _at(u, x):
    """A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]"""
    return (1, 1, 1, 0)[x] if u == 0 else (0, 1, -1, -1)[x]


def _input_transform(x):
    """wino_input_kernel: V [16, Mt, C] bf16, tap 4 x + y, tiles (b, ty, tx)
    row-major, C contiguous; B^T over the patch's rows, then its columns, in
    fp32, as the kernel orders the adds."""
    b, h, w, c = x.shape
    th, tw = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    d = [[xp[:, p:p + 2 * th - 1:2, q:q + 2 * tw - 1:2, :] for q in range(4)] for p in range(4)]
    e = [[d[0][j] - d[2][j], d[1][j] + d[2][j], d[2][j] - d[1][j], d[1][j] - d[3][j]]
         for j in range(4)]
    v = [[e[0][x] - e[2][x], e[1][x] + e[2][x], e[2][x] - e[1][x], e[1][x] - e[3][x]]
         for x in range(4)]
    return torch.stack([v[x][y] for x in range(4) for y in range(4)]).reshape(
        16, b * th * tw, c).to(torch.bfloat16)


def _kernel_model(x, u, bias, plan):
    """The kernel's tiles, walked in its order (tile_of): per block tile,
    for each tap of its split, M_t = V_t U_t^T (fp32 sums), folded into
    Y[u][v] with A^T's coefficients in tap order; the epilogue writes pixel
    (2 ty + u, 2 tx + v), masked past the frame and O, as bf16(Y) (+ bias in
    bf16), or, split, the fp32 partials summed in split order. Returns the
    output [B, H, W, O] and how often each output was written (once per
    split)."""
    b, h, w, _ = x.shape
    o = u.shape[1]
    v = _input_transform(x).float()
    uf = u.float()
    pixels = b * h * w
    partial = torch.zeros((plan.splits, pixels, o))
    out = torch.zeros((pixels, o), dtype=torch.bfloat16)
    hits = torch.zeros((pixels, o), dtype=torch.int64)
    taps = pw.TAPS // plan.splits
    for t in range(plan.m_tiles * plan.n_tiles * plan.splits):
        n0 = t % plan.n_tiles * pw.TILE_COLS
        rest = t // plan.n_tiles
        s, m0 = rest % plan.splits, rest // plan.splits * pw.TILE_ROWS
        rows = torch.arange(m0, min(m0 + pw.TILE_ROWS, plan.tiles))
        cols = torch.arange(n0, min(n0 + pw.TILE_COLS, o))
        y = torch.zeros((4, len(rows), len(cols)))
        for tap in range(s * taps, (s + 1) * taps):
            m = v[tap, rows] @ uf[tap, cols].t()
            for uv in range(4):
                cf = _at(uv >> 1, tap >> 2) * _at(uv & 1, tap & 3)
                if cf:
                    y[uv] = y[uv] + m if cf > 0 else y[uv] - m
        bi, r = rows // (plan.th * plan.tw), rows % (plan.th * plan.tw)
        for uv in range(4):
            oy, ox = 2 * (r // plan.tw) + (uv >> 1), 2 * (r % plan.tw) + (uv & 1)
            keep = (oy < h) & (ox < w)
            pix = ((bi * h + oy) * w + ox)[keep]
            idx = (pix[:, None], cols[None, :])
            if plan.splits > 1:
                partial[s][idx] = y[uv][keep]
            else:
                val = y[uv][keep].to(torch.bfloat16)
                out[idx] = val if bias is None else val + bias[cols]
            hits[idx] += 1
    if plan.splits > 1:
        total = torch.zeros((pixels, o))
        for s in range(plan.splits):
            total = total + partial[s]
        out = total.to(torch.bfloat16)
        if bias is not None:
            out = out + bias
    return out.reshape(b, h, w, o), hits


def _operands(b, h, w, c, o, seed=0):
    x = randn(seed, b, h, w, c)
    wt = randn(seed + 1, 3, 3, c, o, scale=(9 * c) ** -0.5)  # HWIO
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    u = pw.winograd_weight(torch.from_numpy(np.ascontiguousarray(
        np.asarray(wb.astype(jnp.float32)).transpose(3, 2, 0, 1))).to(torch.bfloat16))
    return xb, wb, torch.from_numpy(np.array(xb.astype(jnp.float32))), u


@pytest.mark.parametrize("shape", [
    (1, 7, 9, 32, 40),     # odd H and W, one partial channel tile
    (2, 13, 20, 96, 136),  # C = 96 (1.5 k steps a tap), O past two tiles, odd H
])
def test_kernel_model_matches_fused_pallas_kernel(shape):
    """The model, with the plan the card gets (the taps split) and with one
    for a card of one SM (not split), against the TPU kernel."""
    b, h, w, c, o = shape
    xb, wb, x, u = _operands(*shape)
    ref = np.asarray(conv3x3_wino_fused(xb, wb, block_tr=4, interpret=True), np.float32)
    splits = set()
    for sms in (SMS, 1):
        plan = pw.wino_plan(b, h, w, c, o, sms)
        splits.add(plan.splits)
        out, hits = _kernel_model(x, u, None, plan)
        assert (hits == plan.splits).all()
        err = np.abs(out.float().numpy() - ref)
        assert np.all(err <= BF16_ULP * np.abs(ref) + 1e-6), (sms, err.max())
    assert 1 in splits and len(splits) == 2


def test_kernel_model_with_bias_matches_the_plain_version():
    """The bias goes on after the output's bf16 rounding, split or not."""
    b, h, w, c, o = 2, 9, 11, 64, 72
    _, _, x, u = _operands(b, h, w, c, o, seed=3)
    bias = torch.from_numpy(randn(5, o, scale=0.3)).to(torch.bfloat16)
    ref = pw.conv3x3_winograd_plain(x, u, torch.bfloat16, bias).float()
    for sms in (SMS, 1):
        plan = pw.wino_plan(b, h, w, c, o, sms)
        out, hits = _kernel_model(x, u, bias, plan)
        assert (hits == plan.splits).all()
        assert (out.float() - ref).abs().max() <= REL_TOL * ref.abs().max()


def test_input_transform_layout():
    """V [16, Mt, C]: tap 4 x + y of tile (b, ty, tx) at row (b th + ty) tw +
    tx is B^T d B of the zero-padded 4x4 patch at (2 ty - 1, 2 tx - 1)."""
    b, h, w, c = 2, 5, 7, 32
    x = torch.from_numpy(randn(7, b, h, w, c)).to(torch.bfloat16)
    v = _input_transform(x)
    th, tw = 3, 4
    assert v.shape == (16, b * th * tw, c) and v.dtype == torch.bfloat16
    bt = torch.tensor([[1., 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]])
    xp = F.pad(x.float(), (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    for bi, ty, tx in ((0, 0, 0), (1, 2, 3), (0, 1, 2), (1, 2, 0)):
        d = xp[bi, 2 * ty:2 * ty + 4, 2 * tx:2 * tx + 4]  # [4, 4, C]
        want = torch.einsum("xi,ijc,yj->xyc", bt, d, bt).reshape(16, c)
        got = v[:, (bi * th + ty) * tw + tx].float()
        assert torch.allclose(got, want.to(torch.bfloat16).float(), atol=0, rtol=2 ** -7)


# the Winograd sites of the flagship opt-in path (batch 2; the VAE's at 2b)
# and at batch 16, (b, h, w, c, o)
_SITES = [(bt, 45, 80, 320, 320) for bt in (2, 16)] + \
    [(bt, 45, 80, 640, 320) for bt in (2, 16)] + [(bt, 23, 40, 640, 640) for bt in (2, 16)] + \
    [(2 * bt, 45, 80, 512, 512) for bt in (2, 16)] + [(4, 180, 320, 128, 256)]


@pytest.mark.parametrize("site", _SITES, ids=lambda s: "x".join(map(str, s)))
def test_plan_at_flagship_shapes(site):
    b, h, w, c, o = site
    plan = pw.wino_plan(b, h, w, c, o, SMS)
    th, tw = (h + 1) // 2, (w + 1) // 2
    assert (plan.th, plan.tw, plan.tiles) == (th, tw, b * th * tw)
    assert plan.m_tiles * pw.TILE_ROWS >= plan.tiles > (plan.m_tiles - 1) * pw.TILE_ROWS
    assert plan.n_tiles * pw.TILE_COLS >= o > (plan.n_tiles - 1) * pw.TILE_COLS
    assert plan.splits in pw.TAP_SPLITS and pw.TAPS % plan.splits == 0
    assert plan.kc == -(-c // pw.K_STEP)
    assert plan.grid == min(plan.m_tiles * plan.n_tiles * plan.splits, SMS)
    # 3D maps (C, rows, tap): a box never crosses into the next tap
    assert plan.v_map == ((c, plan.tiles, 16), (pw.K_STEP, pw.TILE_ROWS, 1))
    assert plan.u_map == ((c, o, 16), (pw.K_STEP, pw.TILE_COLS, 1))
    assert plan.workspace_bytes == (4 * plan.splits * b * h * w * o if plan.splits > 1 else 0)
    # 128 bytes of bf16 a k step (the 128-byte swizzle)
    assert pw.K_STEP * 2 == 128


@pytest.mark.parametrize("site,want", [
    ((2, 45, 80, 320, 320), (1, 75)),    # 15 x 5 tiles: one wave unsplit
    ((2, 23, 40, 640, 640), (2, 80)),    # 4 x 10 tiles: split in two
    ((4, 45, 80, 512, 512), (1, 132)),   # 29 x 8 tiles: persistent blocks
    ((1, 1, 1, 32, 32), (4, 4)),
])
def test_pinned_plans(site, want):
    plan = pw.wino_plan(*site, SMS)
    assert (plan.splits, plan.grid) == want


def test_plan_prefers_fewer_splits_on_a_tie():
    for site in _SITES:
        plan = pw.wino_plan(*site, SMS)
        if plan.m_tiles * plan.n_tiles >= SMS:
            assert plan.splits == 1, site
