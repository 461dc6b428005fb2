"""The dynamic int8 conv and dense kernels' host plan and arithmetic
(ops/kernels/conv2d.py::dynamic_plan, csrc/act_quantize.cuh, csrc/
sm90_conv.cuh's loader quantize, csrc/conv2d_int8.cu's small dense), on the
CPU, without the card:

- the plan at the flagship's dynamic sites at batch 2 and 16: which route
  each takes (one launch for the small dense layers, the row quantize for
  the others, the loader quantize or the separate pass for a convolution),
  the small-dense threshold, the absmax chunks a group, shared memory within
  the H100's 227 KB, and no split of K whose sum launch costs the host more
  than it saves; route_plan's forced routes and limits; the chunks of at
  most MAX_GROUPS items a larger convolution runs in, bit-equal to the
  JAX conv over the whole batch;
- plain models of the kernels' walks: the fused row quantize (a team of
  threads a row, each 16-byte vector once), the absmax slots and their fold,
  the loader quantize's conversion of TMA's swizzled bf16 boxes into the
  wgmma A fragments, the small dense's int8 tile writes; each bit-equal to
  conv2d_int8_dynamic_plain and to the jitted JAX int8_dot_general /
  int8_conv_general_dilated, with rows and items of different absmax, an
  all-zero item and K = 5120;
- the division-free quantize (the product with the reciprocal, Markstein's
  fma correction) over every finite bf16 value at 20 scales, ties and the
  +-127 clip included, its fmas emulated exactly, bit-equal to
  quantize_int8_plain.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops import quant as jq
from d3roma_tpu_torch.ops.kernels import conv2d as pc
from d3roma_tpu_torch.ops.kernels.quantize import (
    INV127,
    dynamic_scale_plain,
    quantize_int8_plain,
    quantize_weight,
)
from torch_port_utils import randn

SMS = 132
F32 = np.float32
ROUND = F32(12582912.0)  # 1.5 * 2^23


def clip127(v):
    """fminf(fmaxf(v, -127), 127): a NaN becomes -127, as CUDA's fmaxf
    returns the other operand."""
    return np.fmin(np.fmax(v, F32(-127)), F32(127)).astype(F32)


# ---------------------------------------------------------------------------
# the arithmetic of csrc/act_quantize.cuh, in numpy fp32 (IEEE, no flush)


def group_scale(amax):
    return np.maximum((np.asarray(amax, F32) * F32(INV127)).astype(F32), F32(1e-8))


def fma32(a, b, c):
    """fl32(a * b + c), one rounding (the card's fma): the product is exact
    in fp64 (24 x 24 bits); where the fp64 sum is exact too (TwoSum's error
    0) it rounds once to fp32, elsewhere the exact rational is rounded to the
    nearest fp32, ties to even."""
    a, b, c = (np.broadcast_to(np.asarray(t, F32), np.broadcast(a, b, c).shape) for t in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    with np.errstate(all="ignore"):
        s = p + c64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)
        out = s.astype(F32)
    for i in zip(*np.nonzero((err != 0) & np.isfinite(s))):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = F32(float(exact))
        out[i] = min((np.nextafter(near, F32(-np.inf)), near, np.nextafter(near, F32(np.inf))),
                     key=lambda t: (abs(Fraction(float(t)) - exact),
                                    int(np.asarray(t, F32).view(np.uint32)) & 1))
    return out


def quant_fast(x, s):
    """act_quantize.cuh::quant_fast at scale s: q0 = fl(x * fl(1/s)), q1 =
    fma(fma(-q0, s, x), r, q0) (Markstein's correctly rounded quotient),
    q0 where |q1| > 128 or q1 is NaN, the clip, the 1.5 * 2^23 rounding; the
    int8 as the low byte of the sum."""
    x = np.asarray(x, F32)
    s = np.broadcast_to(np.asarray(s, F32), x.shape)
    with np.errstate(all="ignore"):
        r = (F32(1.0) / s).astype(F32)
        q0 = (x * r).astype(F32)
        q1 = fma32(fma32(-q0, s, x), r, q0)
        y = clip127(np.where(np.abs(q1) <= 128, q1, q0).astype(F32))
        z = (y + ROUND).astype(F32)
    return (z.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def _all_finite_bf16():
    v = (np.arange(65536, dtype=np.uint32) << 16).view(F32)
    return v[np.isfinite(v)]


SCALES = [1e-8, 2.0 ** -10, 0.25, 1.0, 3.0, float(F32(1 / 127)), 1e30, 2.6e36] + [
    float(s) for s in F32(np.random.RandomState(7).lognormal(0.0, 3.0, 12))]


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"{s:.3g}")
def test_fast_division_is_bit_equal_over_every_bf16(scale):
    x = _all_finite_bf16()
    got = quant_fast(x, scale)
    ref = quantize_int8_plain(torch.from_numpy(x), float(F32(scale))).numpy()
    np.testing.assert_array_equal(got, ref)
    ratio = np.abs(x.astype(np.float64) / F32(scale))
    if scale in (2.0 ** -10, 0.25, 1.0):  # exact ties k + 0.5 exist: half to even
        ties = (ratio % 1 == 0.5) & (ratio < 127)
        assert ties.any() and (got[ties] % 2 == 0).all()
    if ratio.max() > 200:  # the clip is reached on both sides
        assert got.max() == 127 and got.min() == -127


def test_fast_division_on_nan_and_infinities_as_the_kernel():
    """NaN -> -127 (fmaxf(NaN, -127)), +-inf -> +-127; an infinite scale
    sends finite values to 0 and infinities to -127, as the IEEE division
    does in quant1 (there q1 is NaN and q0 takes its place)."""
    x = np.array([np.nan, np.inf, -np.inf, 1.0, -3.0, 0.0], F32)
    np.testing.assert_array_equal(quant_fast(x, F32(0.5)), [-127, 127, -127, 2, -6, 0])
    np.testing.assert_array_equal(quant_fast(x, F32(np.inf)), [-127, -127, -127, 0, 0, 0])


# ---------------------------------------------------------------------------
# walks of the kernels


def _rows_bf16(rows, k, seed, zero_row=True):
    """[rows, k] bf16 values (as fp32), row i scaled by 1 + i, the last
    row all zeros."""
    x = randn(seed, rows, k) * np.arange(1, rows + 1, dtype=F32)[:, None]
    if zero_row:
        x[-1] = 0.0
    return torch.from_numpy(x.astype(F32)).to(torch.bfloat16).float().numpy()


def row_quantize_model(x, team, vecs):
    """row_quantize_kernel: thread lt of a row's team holds the row's
    16-byte vectors lt + j * team (j < vecs), reduces their |x| max, the
    team's max goes through the warps; each vector quantized once at the
    row's scale. Returns the int8 rows and each row's absmax."""
    rows, k = x.shape
    nv = k // 8
    assert team * vecs >= nv
    q = np.zeros((rows, k), np.int8)
    amax = np.zeros(rows, F32)
    seen = np.zeros((rows, nv), np.int64)
    for r in range(rows):
        lane_max = np.zeros(team, F32)
        for lt in range(team):
            for j in range(vecs):
                i = lt + j * team
                if i < nv:
                    lane_max[lt] = max(lane_max[lt], np.abs(x[r, 8 * i:8 * i + 8]).max())
        warp_max = lane_max.reshape(-1, 32).max(axis=1)
        amax[r] = warp_max.max()
        s = group_scale(amax[r])
        for lt in range(team):
            for j in range(vecs):
                i = lt + j * team
                if i < nv:
                    q[r, 8 * i:8 * i + 8] = quant_fast(x[r, 8 * i:8 * i + 8], s)
                    seen[r, i] += 1
    assert (seen == 1).all()
    return q, amax


def _dense_out(q, amax, wq, ws, bias):
    """The GEMM's epilogue of the rows route: exact int32 sums, (acc * s_row)
    * ws in fp32, one cast to bf16, the bias added in bf16."""
    acc = torch.from_numpy(q).double() @ wq.double().t()
    s = torch.from_numpy(group_scale(amax))[:, None]
    out = (acc.float() * s * ws).to(torch.bfloat16)
    return out + bias


@pytest.mark.parametrize("rows,k", [(6, 5120), (5, 320), (4, 1024), (3, 2560)])
def test_row_quantize_walk_is_the_plain_and_the_jax_dense(rows, k):
    team, vecs = pc.row_team(k)
    x = _rows_bf16(rows, k, seed=k)
    q, amax = row_quantize_model(x, team, vecs)
    xt = torch.from_numpy(x)
    s = dynamic_scale_plain(xt, (1,))
    np.testing.assert_array_equal(group_scale(amax), s[:, 0].numpy())
    np.testing.assert_array_equal(q, quantize_int8_plain(xt, s).numpy())
    assert amax[-1] == 0 and (q[-1] == 0).all() and group_scale(amax[-1]) == F32(1e-8)
    # the whole dense against the jitted JAX int8_dot_general (+ bias)
    n = 40
    w, b = randn(k + 1, k, n, scale=k ** -0.5), randn(k + 2, n, scale=0.1)
    wq, ws = quantize_weight(torch.from_numpy(w).to(torch.bfloat16).t())
    bias = torch.from_numpy(b).to(torch.bfloat16)
    got = _dense_out(q, amax, wq, ws, bias)
    ref = jax.jit(lambda a, kk: jq.int8_dot_general(a, kk, (((1,), (0,)), ((), ()))))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)) + jnp.asarray(b, jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    plain = pc.conv2d_int8_dynamic_plain(xt.to(torch.bfloat16).view(1, 1, rows, k),
                                         wq.view(n, 1, 1, k), ws, bias, 1, 0, per_row=True)
    np.testing.assert_array_equal(got.float().numpy(), plain.view(rows, n).float().numpy())


def _swizzle(offset):
    """TMA's CU_TENSOR_MAP_SWIZZLE_128B within a 1024-byte aligned tile: the
    16-byte chunk bits [4:6] of a byte offset XOR its 128-byte row bits
    [7:9]."""
    return offset ^ (((offset >> 7) & 7) << 4)


def test_small_dense_tile_writes_are_the_tma_layout():
    """dense_small_int8_kernel writes the 8 int8 of row r's 16-byte bf16
    vector i (K positions 8i..8i+7) at tile i // 16, row r, 16-byte chunk
    ((i % 16) // 2) ^ (r % 8), half i % 2: the bytes TMA's 128-byte swizzle
    puts there, which the wgmma descriptor reads; the vectors of a lane (i =
    lane + 32 j, j < 8) cover K <= 2048 once."""
    for r in range(64):
        for i in range(pc.SMALL_MAX_K // 8):
            thread = (i // 16) * 8192 + r * 128 + ((((i % 16) // 2) ^ (r % 8)) << 4) + (i % 2) * 8
            assert thread == _swizzle((i // 16) * 8192 + r * 128 + (i % 16) * 8)
    covered = sorted(lane + 32 * j for lane in range(32) for j in range(8))
    assert covered == list(range(pc.SMALL_MAX_K // 8))


def _stage_from_tma(xrows, c0, cin):
    """A loader-quantize stage as TMA leaves it: the box of 64 bf16 channels
    at c0 and, where c0 + 64 < cin, the one at c0 + 64, 128 rows each,
    swizzled; channels past cin zero-filled; the second box, when absent,
    holding stale bytes. As uint8 [32768]."""
    rng = np.random.RandomState(c0)
    stage = rng.randint(0, 256, 2 * 16384).astype(np.uint8)  # stale bytes
    bits = torch.from_numpy(xrows).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8)
    for box in range(2):
        lo = c0 + 64 * box
        if box == 1 and lo >= cin:
            continue
        for row in range(xrows.shape[0]):
            line = np.zeros(128, np.uint8)
            n = max(0, min(64, cin - lo))
            line[:2 * n] = bits[row, 2 * lo:2 * (lo + n)]
            for chunk in range(8):
                at = box * 16384 + _swizzle(row * 128 + chunk * 16)
                stage[at:at + 16] = line[16 * chunk:16 * chunk + 16]
    return stage


def _box_word(line0, q4, kk, e):
    """sm90_conv.cuh::box_word: the byte offset in a stage of the four bf16
    of fragment word e of k32 step kk for a thread whose rows start at
    line0 and columns at q4."""
    line = line0 + 8 * (e & 1)
    cb = 32 * (kk % 2) + 16 * (e >> 1) + q4
    return (kk // 2) * 16384 + line * 128 + (((cb // 8) ^ (line & 7)) << 4) + (cb % 8) * 2


def loader_fragments_model(stage, cin, c0, scales):
    """sm90_conv.cuh::mma_loadq's conversion for both consumer warpgroups:
    thread (warp w, lane l) of warpgroup wg reads the four bf16 of each
    fragment word (k32 step kk, word e) from the boxes (zeros for the second
    box when it is absent) and quantizes them at its row's scale; the words
    laid out as mma.m16n8k32's A fragments (rows 16 w + l / 4 (+ 8), columns
    4 (l % 4) (+ 16) within each k32 step) give the warpgroups' A tiles,
    [128 rows, 128 channels], each element written once."""
    second = c0 + 64 < cin
    tile = np.full((128, 128), 999, np.int16)
    for wg in range(2):
        for t in range(128):
            w, lane = t // 32, t % 32
            line0, q4 = wg * 64 + 16 * w + lane // 4, 4 * (lane % 4)
            for kk in range(4):
                for e in range(4):
                    line = line0 + 8 * (e & 1)
                    if kk >= 2 and not second:
                        raw = np.zeros(8, np.uint8)
                    else:
                        at = _box_word(line0, q4, kk, e)
                        raw = stage[at:at + 8]
                    vals = torch.from_numpy(raw.view(np.int16).copy()).view(
                        torch.bfloat16).float().numpy()
                    col = 32 * kk + 16 * (e >> 1) + q4
                    assert (tile[line, col:col + 4] == 999).all()
                    tile[line, col:col + 4] = quant_fast(vals, scales[line])
    assert (tile != 999).all()
    return tile.astype(np.int8)


@pytest.mark.parametrize("cin,c0", [(32, 0), (96, 0), (320, 256), (320, 128), (128, 0)])
def test_loader_quantize_converts_the_tma_boxes(cin, c0):
    """The A fragments the loader quantize converts from TMA's swizzled bf16
    boxes of a k step are quantize_int8_plain of its 128 channels (zero past
    Cin; the second box's stale bytes unread when it is absent) at each
    row's scale, rows of different scales, an all-zero row among them."""
    rows = _rows_bf16(128, cin, seed=cin + c0)
    scales = group_scale(np.abs(rows).max(axis=1))
    tile = loader_fragments_model(_stage_from_tma(rows, c0, cin), cin, c0, scales)
    want = np.zeros((128, 128), F32)
    hi = min(cin, c0 + 128)
    want[:, :hi - c0] = rows[:, c0:hi]
    ref = quantize_int8_plain(torch.from_numpy(want), torch.from_numpy(scales)[:, None])
    np.testing.assert_array_equal(tile, ref.numpy())


def absmax_slots_model(x, groups, chunk, chunks):
    """absmax_slots_kernel: block g * chunks + c takes the max |x| of chunk c
    of group g; the readers fold a group's slots."""
    flat = np.abs(x.reshape(groups, -1))
    slots = np.zeros((groups, chunks), F32)
    for g in range(groups):
        for c in range(chunks):
            part = flat[g, c * chunk:(c + 1) * chunk]
            assert part.size > 0
            slots[g, c] = part.max()
    assert chunks * chunk >= flat.shape[1]
    return slots.max(axis=1)


CONV_CASES = {
    "3x3 stride 1": ((3, 9, 11, 32), 48, 3, 1, 1),
    "3x3 stride 2": ((4, 10, 12, 64), 40, 3, 2, 1),
    "1x1": ((2, 7, 9, 96), 24, 1, 1, 0),
    "3x3 stride 2 valid, many chunks": ((2, 33, 41, 64), 16, 3, 2, 0),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_slot_fold_is_the_plain_and_the_jax_conv(case):
    """The per-item scales folded from the plan's slots, x quantized at them
    (the loader's and the separate pass's arithmetic), exact sums, the "xla"
    epilogue: bit-equal to conv2d_int8_dynamic_plain and the jitted JAX
    int8_conv_general_dilated, items of different absmax, one all zeros."""
    shape, cout, k, stride, pad = CONV_CASES[case]
    b, h, w, cin = shape
    x = randn(len(case), *shape) * np.arange(1, b + 1, dtype=F32).reshape(-1, 1, 1, 1)
    x[-1] = 0.0
    xt = torch.from_numpy(x.astype(F32)).to(torch.bfloat16)
    plan = pc.dynamic_plan(b, h, w, cin, cout, k, k, stride, pad, False, SMS)
    chunk, chunks = plan.chunk, plan.chunks
    if case.endswith("many chunks"):  # the plan's walk with several slots a group
        chunk, chunks = 2048, -(-h * w * cin // 2048)
        assert chunks > 1
    amax = absmax_slots_model(xt.float().numpy(), b, chunk, chunks)
    s = group_scale(amax)
    np.testing.assert_array_equal(s, dynamic_scale_plain(xt, (1, 2, 3)).flatten().numpy())
    q = quant_fast(xt.float().numpy(), s.reshape(-1, 1, 1, 1))
    wv = randn(len(case) + 1, k, k, cin, cout, scale=(k * k * cin) ** -0.5)
    wq, ws = quantize_weight(torch.from_numpy(wv).to(torch.bfloat16).permute(3, 0, 1, 2))
    acc = pc.conv2d_int8_acc_plain(torch.from_numpy(q), wq, stride, pad).float()
    got = (acc * torch.from_numpy(s).view(-1, 1, 1, 1) * ws).to(torch.bfloat16)
    ref = jax.jit(lambda a, kk: jq.int8_conv_general_dilated(
        a, kk, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))(
        jnp.asarray(xt.float().numpy(), jnp.bfloat16), jnp.asarray(wv, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    plain = pc.conv2d_int8_dynamic_plain(xt, wq, ws, None, stride, pad)
    assert torch.equal(got, plain)
    assert (got[-1] == 0).all()


# ---------------------------------------------------------------------------
# the plan


def _conv_sites():
    """The flagship's dynamic convolutions at batch 2 and 16 (640x360, latent
    45x80; the VAE's encode runs both conditions: 2b)."""
    sites = {}
    for bt in (2, 16):
        for h, w, c in ((45, 80, 320), (23, 40, 640), (12, 20, 1280), (6, 10, 1280)):
            sites[f"b{bt}_3x3_{c}_{h}x{w}"] = (bt, h, w, c, c, 3, 1, 1)
        sites[f"b{bt}_3x3_1920_640"] = (bt, 23, 40, 1920, 640, 3, 1, 1)
        for h, w, c in ((45, 80, 320), (23, 40, 640), (12, 20, 1280)):
            sites[f"b{bt}_s2_{c}"] = (bt, h, w, c, c, 3, 2, 1)
        sites[f"b{bt}_1x1_640_320"] = (bt, 45, 80, 640, 320, 1, 1, 0)
        sites[f"b{bt}_vae_3x3_128"] = (2 * bt, 360, 640, 128, 128, 3, 1, 1)
        sites[f"b{bt}_vae_s2_128"] = (2 * bt, 361, 641, 128, 128, 3, 2, 0)
        sites[f"b{bt}_vae_1x1_256_128"] = (bt, 360, 640, 256, 128, 1, 1, 0)
    return sites


CONV_SITES = _conv_sites()
LOADER_SITES = {f"b{bt}_{site}" for bt in (2, 16)
                for site in ("1x1_640_320", "vae_1x1_256_128", "vae_s2_128")} | {"b2_s2_640"}


def _dense_sites():
    sites = {}
    for bt in (2, 16):
        for t, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280)):
            sites[f"b{bt}_proj_{c}_{t}"] = (bt * t, c, c)
            sites[f"b{bt}_ff1_{c}_{t}"] = (bt * t, c, 8 * c)
            sites[f"b{bt}_ff2_{c}_{t}"] = (bt * t, 4 * c, c)
        for c in (320, 640, 1280):
            sites[f"b{bt}_kv_{c}"] = (2 * bt, 1024, c)
        sites[f"b{bt}_time"] = (bt, 320, 1280)
    return sites


DENSE_SITES = _dense_sites()


def _split_check(plan, per_row, site):
    """No split whose sum launch costs the host more than it saves: the
    plan's modelled cost beats the same tiles unsplit."""
    if plan.conv is None or plan.conv.splits == 1:
        return
    if per_row:
        rows, cin, cout = site
        view, kh, stride = (1, 1, rows), 1, 1
    else:
        b, h, w, cin, cout, kh, stride, pad = site
        view = pc.flat_view(b, h, w, kh, kh, stride, pad)
    oh, ow = pc.conv_out_hw(view[1], view[2], kh, stride, 0 if per_row else site[7])
    convert = pc.CONVERT_STEP_UNITS if plan.route == "loader" else 0
    unsplit = pc.plan_cost(view[0], oh, ow, cout, plan.conv.box, plan.conv.bn, 1,
                           plan.conv.k_steps, pc.DYNAMIC_LAUNCH_UNITS, convert, SMS)
    assert unsplit - plan.conv.cost >= 0
    split_traffic = (plan.conv.splits + 1) * 4 * view[0] * oh * ow * cout / \
        pc.SPLIT_BYTES_PER_UNIT
    assert unsplit - (plan.conv.cost - split_traffic) >= pc.DYNAMIC_LAUNCH_UNITS


@pytest.mark.parametrize("name", sorted(CONV_SITES))
def test_conv_plan_at_flagship_sites(name):
    b, h, w, cin, cout, k, stride, pad = site = CONV_SITES[name]
    plan = pc.dynamic_plan(b, h, w, cin, cout, k, k, stride, pad, False, SMS)
    if (k, stride) == (3, 1):
        assert plan.route == "separate"  # nine loads an element: one quantize pass
    # the routes the H100's measured costs give (PERF.md section 6):
    # the loader quantize at the 1x1 convs and the VAE's 128-channel stride
    # 2, the separate pass at the UNet's stride 2 but its batch-2 640
    # (host-bound: the loader's plan has one launch fewer)
    assert plan.route == ("loader" if name in LOADER_SITES else "separate")
    assert 1 <= plan.chunks <= pc.MAX_CHUNKS and plan.chunk % (pc.ABSMAX_THREADS * 8) == 0
    assert (plan.chunks - 1) * plan.chunk < h * w * cin <= plan.chunks * plan.chunk
    assert plan.groups == b <= pc.MAX_GROUPS
    assert plan.smem_bytes <= pc.SMEM_LIMIT
    assert plan.smem_bytes == pc.conv_smem_bytes(plan.conv.bn, plan.route == "loader")
    split = plan.conv.splits > 1
    assert plan.device_ops == {"loader": 2, "separate": 3}[plan.route] + split
    n = b * h * w * cin
    slots = 4 * b * plan.chunks
    assert plan.workspace_bytes == (slots if plan.route == "loader"
                                    else -(-n // 128) * 128 + slots)
    _split_check(plan, False, site)


@pytest.mark.parametrize("name", sorted(DENSE_SITES))
def test_dense_plan_at_flagship_sites(name):
    rows, k, n = site = DENSE_SITES[name]
    plan = pc.dynamic_plan(1, 1, rows, k, n, 1, 1, 1, 0, True, SMS)
    if rows <= pc.SMALL_ROWS:
        assert plan.route == "small" and plan.device_ops == 1 and plan.conv is None
        assert plan.workspace_bytes == 0
    else:
        assert plan.route == "rows"
        assert plan.device_ops == 2 + (plan.conv.splits > 1)
        assert plan.team * plan.vecs * 8 >= k and plan.vecs <= pc.ROW_MAX_VECS
        assert plan.workspace_bytes == -(-rows * k // 128) * 128 + 4 * rows
    assert plan.smem_bytes <= pc.SMEM_LIMIT
    _split_check(plan, True, site)


@pytest.mark.parametrize("rows,route", [(1, "small"), (4, "small"), (32, "small"),
                                        (64, "small"), (65, "rows"), (480, "rows")])
def test_small_dense_threshold(rows, route):
    """One wgmma M (64 rows) is the small route's limit, and its K a warp's
    registers (2048), whose tiles and weights fit shared memory; 2560 goes
    to the rows route."""
    assert pc.dynamic_plan(1, 1, rows, 1024, 320, 1, 1, 1, 0, True, SMS).route == route
    assert pc.small_smem_bytes(pc.SMALL_MAX_K) <= pc.SMEM_LIMIT
    assert pc.dynamic_plan(1, 1, 8, 2048, 320, 1, 1, 1, 0, True, SMS).route == "small"
    assert pc.dynamic_plan(1, 1, 8, 2560, 320, 1, 1, 1, 0, True, SMS).route == "rows"


@pytest.mark.parametrize("k", [320, 640, 1024, 1280, 2048, 2560, 5120, 10240])
def test_row_team_holds_the_row(k):
    team, vecs = pc.row_team(k)
    assert team in (32, 64, 128, 256) and 1 <= vecs <= pc.ROW_MAX_VECS
    assert team * vecs * 8 >= k > (team // 2) * pc.ROW_MAX_VECS * 8 or team == 32


def test_route_override_and_its_limits():
    """route_plan builds any route at one shape (chip_smoke.py checks both
    convolution routes at the 1x1 and stride-2 sites and times "rows"
    against "small"); dynamic_plan is route_plan on the route it picks. A
    dense route at a convolution, more rows or a longer K than the small
    route takes, an unknown route, or more batch items than one launch's
    table of scales holds raise."""
    for site, per_row in ((CONV_SITES["b2_vae_s2_128"], False),
                          (CONV_SITES["b2_s2_320"], False), (DENSE_SITES["b2_kv_320"], True)):
        if per_row:
            rows, k, n = site
            geometry = (1, 1, rows, k, n, 1, 1, 1, 0)
        else:
            b, h, w, cin, cout, k, stride, pad = site
            geometry = (b, h, w, cin, cout, k, k, stride, pad)
        picked = pc.dynamic_plan(*geometry, per_row, SMS)
        assert pc.route_plan(picked.route, *geometry, SMS) == picked
        for route in (("small", "rows") if per_row else ("loader", "separate")):
            assert pc.route_plan(route, *geometry, SMS).route == route
    forced = pc.route_plan("rows", 1, 1, 4, 1024, 320, 1, 1, 1, 0, SMS)
    assert forced.device_ops == 2 + (forced.conv.splits > 1)
    with pytest.raises(ValueError):
        pc.route_plan("small", 1, 1, pc.SMALL_ROWS + 1, 1024, 320, 1, 1, 1, 0, SMS)
    with pytest.raises(ValueError):
        pc.route_plan("small", 1, 1, 8, pc.SMALL_MAX_K + 32, 320, 1, 1, 1, 0, SMS)
    with pytest.raises(ValueError):
        pc.route_plan("fused", 2, 45, 80, 320, 320, 3, 3, 1, 1, SMS)
    with pytest.raises(ValueError):
        pc.route_plan("separate", pc.MAX_GROUPS + 1, 4, 4, 32, 32, 3, 3, 1, 1, SMS)


@pytest.mark.parametrize("b", [1, 128, 129, 130, 256, 300])
def test_dynamic_chunks_cover_the_batch(b):
    """A convolution of more than MAX_GROUPS batch items runs as launches of
    at most MAX_GROUPS, in order, covering every item once, each of which
    the plan takes (the VAE's 128-channel stride 2 at 2 * batch items); a
    dense layer's rows go in one launch."""
    chunks = pc.dynamic_chunks(b, False)
    assert chunks[0][0] == 0 and chunks[-1][1] == b
    assert all(stop == start for (_, stop), (start, _) in zip(chunks, chunks[1:]))
    assert all(0 < stop - start <= pc.MAX_GROUPS for start, stop in chunks)
    assert len(chunks) == -(-b // pc.MAX_GROUPS)
    for start, stop in chunks:
        plan = pc.dynamic_plan(stop - start, 361, 641, 128, 128, 3, 3, 2, 0, False, SMS)
        assert plan.groups == stop - start and plan.smem_bytes <= pc.SMEM_LIMIT
    assert pc.dynamic_chunks(b, True) == ((0, b),)


@pytest.mark.parametrize("stride,k,pad", [(2, 3, 1), (1, 1, 0)])
def test_many_items_in_chunks_match_one_call(stride, k, pad):
    """130 batch items (more than one launch's table of scales) in the
    chunks a CUDA call launches give the jitted JAX
    int8_conv_general_dilated over the whole batch bit for bit, and so
    does the entry point (on the CPU, the plain version in one call): each
    item's scale is its own. Items of different absmax, one all zeros."""
    b, h, w, cin, cout = 130, 3, 5, 32, 16
    x = randn(130 + k, b, h, w, cin) * np.arange(1, b + 1, dtype=F32).reshape(-1, 1, 1, 1)
    x[-1] = 0.0
    xt = torch.from_numpy(x.astype(F32)).to(torch.bfloat16)
    wv = randn(131 + k, k, k, cin, cout, scale=(k * k * cin) ** -0.5)
    wq, ws = quantize_weight(torch.from_numpy(wv).to(torch.bfloat16).permute(3, 0, 1, 2))
    chunks = pc.dynamic_chunks(b, False)
    assert len(chunks) == 2
    parts = torch.cat([pc.conv2d_int8_dynamic_plain(xt[i:j], wq, ws, None, stride, pad)
                       for i, j in chunks])
    ref = jax.jit(lambda a, kk: jq.int8_conv_general_dilated(
        a, kk, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))(
        jnp.asarray(xt.float().numpy(), jnp.bfloat16), jnp.asarray(wv, jnp.bfloat16))
    np.testing.assert_array_equal(parts.float().numpy(), np.asarray(ref, np.float32))
    assert torch.equal(pc.conv2d_int8_dynamic(xt, wq, ws, None, stride, pad), parts)
    assert (parts[-1] == 0).all()


def test_static_plans_keep_their_cost_model():
    """The static calls' plans price a split's launch at the device's cost,
    as before the dynamic routes existed (the dynamic ones at the host's)."""
    static = pc.conv_plan(2, 23, 40, 320, 320, 3, 3, 2, 1, "xla", SMS)
    assert (static.box, static.bn, static.splits) == ((8, 8, 2), 160, 4)
    dynamic = pc.conv_plan(2, 23, 40, 320, 320, 3, 3, 2, 1, "xla", SMS, pc.DYNAMIC_LAUNCH_UNITS)
    assert dynamic.splits == 1


def _call_operands(case):
    x = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16)
    wq = torch.zeros(32, 3, 3, 64, dtype=torch.int8)
    ws, bias = torch.ones(32), torch.zeros(32, dtype=torch.bfloat16)
    if case == "cin":
        x, wq = torch.zeros(2, 4, 4, 48, dtype=torch.bfloat16), torch.zeros(32, 3, 3, 48,
                                                                             dtype=torch.int8)
    elif case == "cout":
        wq, ws, bias = (torch.zeros(33, 3, 3, 64, dtype=torch.int8), torch.ones(33),
                        torch.zeros(33, dtype=torch.bfloat16))
    elif case == "x_fp32":
        x = x.float()
    elif case == "bias_fp32":
        bias = bias.float()
    elif case == "ws_shape":
        ws = torch.ones(31)
    elif case == "wq_strided":
        wq = torch.zeros(32, 3, 3, 128, dtype=torch.int8)[..., :64]
        x = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16)
    elif case == "wq_misaligned":
        wq = torch.zeros(32 * 9 * 64 + 1, dtype=torch.int8)[1:].view(32, 3, 3, 64)
    return x, wq, ws, bias


@pytest.mark.parametrize("case", ["ok", "cin", "cout", "x_fp32", "bias_fp32", "ws_shape",
                                  "wq_strided", "wq_misaligned"])
def test_dynamic_cuda_call_contract(case):
    """The dynamic CUDA call's checks, the static call's two (CPU tensors
    exercise them): bf16 x and bias, Cin % 32 == 0, Cout % 2 == 0, int8 wq
    and fp32 ws [Cout], the weights contiguous and 16-byte aligned."""
    ops = _call_operands(case)

    def check():
        pc._check(*ops, "xla")
        pc._check_cuda(*ops)

    if case == "ok":
        check()
    else:
        with pytest.raises((TypeError, ValueError)):
            check()
