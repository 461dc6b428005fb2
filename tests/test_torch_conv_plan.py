"""The host-side plan of the CUDA convolution (ops/kernels/conv2d.py::
conv_plan), on the CPU: the tiles and the split of K it gives at the
flagship UNet, VAE and dense shapes for both operand types, that its tiles
cover every output pixel once, and that a plain-torch replay of its K split
(int32 partials added, or the "halo" fp32 row partials added in ky order)
equals the int8 kernel's plain version bit for bit, past 2^24 too; and the
checks a CUDA call meets before its launch. Exact throughout: the replays
sum integers in float64."""

import numpy as np
import pytest
import torch

from d3roma_tpu_torch.ops.kernels import conv2d as pc
from torch_port_utils import randn

SMS = 132


def _site(b, h, w, cin, cout, k, stride, padding):
    return dict(b=b, h=h, w=w, cin=cin, cout=cout, k=k, stride=stride, padding=padding)


# the port's conv and dense sites at the flagship geometry (640x360, latent
# 45x80), at batch 2 and 16 (the VAE's encode runs both conditions: 2b)
def _flagship_sites():
    sites = {}
    for bt in (2, 16):
        for h, w, c in ((45, 80, 320), (23, 40, 640), (12, 20, 1280), (6, 10, 1280)):
            sites[f"b{bt}_3x3_{h}x{w}_{c}"] = _site(bt, h, w, c, c, 3, 1, 1)
        sites[f"b{bt}_3x3_23x40_1920_640"] = _site(bt, 23, 40, 1920, 640, 3, 1, 1)
        sites[f"b{bt}_3x3_45x80_640_320"] = _site(bt, 45, 80, 640, 320, 3, 1, 1)
        sites[f"b{bt}_s2_45x80_320"] = _site(bt, 45, 80, 320, 320, 3, 2, 1)
        sites[f"b{bt}_s2_12x20_1280"] = _site(bt, 12, 20, 1280, 1280, 3, 2, 1)
        sites[f"b{bt}_1x1_45x80_640_320"] = _site(bt, 45, 80, 640, 320, 1, 1, 0)
        sites[f"b{bt}_vae_3x3_360x640_128"] = _site(2 * bt, 360, 640, 128, 128, 3, 1, 1)
        sites[f"b{bt}_vae_3x3_90x160_512"] = _site(bt, 90, 160, 512, 512, 3, 1, 1)
        sites[f"b{bt}_vae_s2_361x641_128"] = _site(2 * bt, 361, 641, 128, 128, 3, 2, 0)
        sites[f"b{bt}_vae_1x1_360x640_256_128"] = _site(bt, 360, 640, 256, 128, 1, 1, 0)
        for tokens, c in ((3600, 320), (920, 640), (240, 1280), (60, 1280)):
            sites[f"b{bt}_dense_{bt * tokens}_{c}"] = _site(1, 1, bt * tokens, c, c, 1, 1, 0)
    return sites


SITES = _flagship_sites()
EPILOGUES = ("xla", "tpu", "halo", "bf16")


def _plan(site, epilogue):
    s = site
    vb, vh, vw = pc.flat_view(s["b"], s["h"], s["w"], s["k"], s["k"], s["stride"],
                              s["padding"])
    oh, ow = pc.conv_out_hw(vh, vw, s["k"], s["stride"], s["padding"])
    plan = pc.conv_plan(vb, oh, ow, s["cin"], s["cout"], s["k"], s["k"], s["stride"],
                        2 if epilogue == "bf16" else 1, epilogue, SMS)
    return (vb, oh, ow), plan


def _split_ranges(plan):
    """The k steps [first, last) of each split, in split order, as the
    kernel's tile_of cuts them (csrc/sm90_conv.cuh)."""
    return [(s * plan.per, min((s + 1) * plan.per, plan.k_steps)) for s in range(plan.splits)]


def _check_plan(view, site, plan, epilogue, min_use=0.0):
    b, oh, ow = view
    bw, bh, bb = plan.box
    stride, k, cin, cout = site["stride"], site["k"], site["cin"], site["cout"]
    # TMA's and the kernel's limits
    assert 1 <= bw * bh * bb <= pc.BLOCK_ROWS
    assert bw * stride <= 256 and bh * stride <= 256
    assert plan.bn in (pc.HALO_TILE_COLS if epilogue == "halo" else pc.TILE_COLS)
    # K: every split non-empty, together all k steps; "halo" only at ky rows
    kc = -(-cin * (2 if epilogue == "bf16" else 1) // pc.K_STEP_BYTES)
    assert plan.k_steps == k * k * kc
    ranges = _split_ranges(plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_steps
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    if epilogue == "halo":
        assert plan.per % (k * kc) == 0
    pixels = b * oh * ow
    assert plan.workspace_bytes == (4 * plan.splits * pixels * cout if plan.splits > 1 else 0)
    # the boxes cover every output pixel exactly once (and at the flagship
    # shapes waste few rows)
    tx, ty, tz = -(-ow // bw), -(-oh // bh), -(-b // bb)
    hits = np.zeros((b, oh, ow), dtype=np.int64)
    for z in range(tz):
        for y in range(ty):
            for x in range(tx):
                hits[z * bb:(z + 1) * bb, y * bh:(y + 1) * bh, x * bw:(x + 1) * bw] += 1
    assert (hits == 1).all()
    assert pixels / (tx * ty * tz * pc.BLOCK_ROWS) >= min_use


def _orders(site):
    """The epilogues a site can take: "tpu", "halo" and the bf16 body serve
    only the stride-1 3x3 sites."""
    return EPILOGUES if (site["k"], site["stride"]) == (3, 1) else ("xla",)


@pytest.mark.parametrize("name,epilogue", [(n, e) for n, s in SITES.items() for e in _orders(s)])
def test_plan_at_flagship_shapes(name, epilogue):
    site = SITES[name]
    view, plan = _plan(site, epilogue)
    _check_plan(view, site, plan, epilogue, min_use=0.9)


# (site, epilogue) -> (box, bn, splits, per): the plans that set the
# flagship numbers in PERF.md
PINNED = {
    ("b2_3x3_12x20_1280", "bf16"): ((20, 3, 2), 160, 4, 45),
    ("b2_3x3_23x40_640", "bf16"): ((8, 8, 2), 160, 2, 45),
    ("b2_3x3_45x80_320", "bf16"): ((40, 3, 1), 160, 1, 45),
    ("b2_3x3_23x40_1920_640", "xla"): ((8, 8, 2), 160, 2, 68),
    ("b2_3x3_45x80_320", "halo"): ((40, 3, 1), 128, 1, 27),
    ("b2_vae_3x3_360x640_128", "halo"): ((128, 1, 1), 128, 1, 9),
    ("b2_vae_s2_361x641_128", "xla"): ((64, 1, 2), 128, 1, 9),
    ("b2_dense_7200_320", "xla"): ((127, 1, 1), 160, 1, 3),
    ("b2_dense_120_1280", "xla"): ((120, 1, 1), 64, 4, 3),
}


@pytest.mark.parametrize("key", list(PINNED), ids=lambda k: f"{k[0]}-{k[1]}")
def test_pinned_flagship_plans(key):
    _, plan = _plan(SITES[key[0]], key[1])
    assert (plan.box, plan.bn, plan.splits, plan.per) == PINNED[key]


def test_plans_for_random_shapes_keep_the_limits():
    """Shapes the flagship does not use (odd frames, small batches, every
    stride and kernel the kernel takes) still give plans within its limits."""
    rs = np.random.RandomState(0)
    for _ in range(60):
        k, stride = [(1, 1), (3, 1), (3, 2)][rs.randint(3)]
        padding = 0 if k == 1 else int(rs.randint(2))
        site = _site(int(rs.randint(1, 6)), int(rs.randint(3, 90)), int(rs.randint(3, 300)),
                     32 * int(rs.randint(1, 41)), 2 * int(rs.randint(1, 700)), k, stride,
                     padding)
        for epilogue in _orders(site):
            view, plan = _plan(site, epilogue)
            _check_plan(view, site, plan, epilogue) if min(view) > 0 else None


def test_flat_view_only_for_unpadded_1x1_stride_1():
    assert pc.flat_view(2, 45, 80, 1, 1, 1, 0) == (1, 1, 7200)
    assert pc.flat_view(2, 45, 80, 3, 3, 1, 1) == (2, 45, 80)
    assert pc.flat_view(2, 45, 80, 1, 1, 2, 0) == (2, 45, 80)


# ---------------------------------------------------------------------------
# The split of K, replayed in plain torch


def _k_step_weights(wq, ks, kc):
    """wq with every weight zeroed outside k step ks (tap ks // kc, Cin
    bytes [128 (ks % kc), +128))."""
    kw = wq.shape[2]
    tap, c0 = divmod(ks, kc)
    ky, kx = divmod(tap, kw)
    out = torch.zeros_like(wq)
    sl = slice(c0 * pc.K_STEP_BYTES, (c0 + 1) * pc.K_STEP_BYTES)
    out[:, ky, kx, sl] = wq[:, ky, kx, sl]
    return out


def _replay(xq, wq, stride, padding, plan, halo):
    """The kernel's sums under `plan`: each split's k steps (int32, or for
    "halo" each row of taps' int32 partial added in fp32 from 0), then the
    splits added (exactly, or in fp32 in split order from 0)."""
    cin, kh, kw = wq.shape[3], wq.shape[1], wq.shape[2]
    kc = -(-cin // pc.K_STEP_BYTES)
    row_steps = kw * kc
    total = None
    for k0, k1 in _split_ranges(plan):
        if halo:
            part = torch.zeros((), dtype=torch.float32)
            for r0 in range(k0, k1, row_steps):
                w_row = sum(_k_step_weights(wq, ks, kc) for ks in range(r0, r0 + row_steps))
                part = part + pc.conv2d_int8_acc_plain(xq, w_row, stride, padding).float()
        else:
            w_split = sum(_k_step_weights(wq, ks, kc) for ks in range(k0, k1))
            part = pc.conv2d_int8_acc_plain(xq, w_split, stride, padding).long()
        total = part if total is None else total + part
        if halo and total is part:
            total = torch.zeros((), dtype=torch.float32) + part
    return total if halo else total.to(torch.int32)


def _int8_operands(b, h, w, cin, cout, k, seed):
    rs = np.random.RandomState(seed)
    xq = torch.from_numpy(rs.randint(-127, 128, (b, h, w, cin)).astype(np.int8))
    wq = torch.from_numpy(rs.randint(-127, 128, (cout, k, k, cin)).astype(np.int8))
    return xq, wq


# sites whose plan splits K (and one that does not), replayed on a small
# frame with few output channels: the split depends on Cin and the taps
_SPLIT_SITES = ["b2_3x3_23x40_1920_640", "b2_3x3_12x20_1280", "b2_3x3_6x10_1280",
                "b2_s2_45x80_320", "b2_dense_120_1280", "b2_3x3_45x80_320"]


@pytest.mark.parametrize("name,epilogue", [(n, e) for n in _SPLIT_SITES
                                            for e in ("xla", "halo") if e in _orders(SITES[n])])
def test_split_replay_equals_the_plain_sums(name, epilogue):
    site = SITES[name]
    _, plan = _plan(site, epilogue)
    k, stride, padding = site["k"], site["stride"], site["padding"]
    xq, wq = _int8_operands(1, 4, 5, site["cin"], 6, k, seed=len(name))
    got = _replay(xq, wq, stride, padding, plan, epilogue == "halo")
    if epilogue == "halo":
        ref = pc.conv2d_int8_halo_sum_plain(xq, wq, stride, padding)
    else:
        ref = pc.conv2d_int8_acc_plain(xq, wq, stride, padding)
    assert got.dtype == ref.dtype
    assert torch.equal(got, ref)


def _saturated(cin, cout, seed=0):
    """As test_torch_conv_entry.py's saturated inputs, quantized: a row of
    taps' int32 partial is about 105 * 105 * 3 * Cin, past 2^24 at
    Cin = 512."""
    rs = np.random.RandomState(seed)
    x = (4.0 + 0.2 * rs.standard_normal((1, 4, 6, cin))).astype(np.float32)
    wt = (1.0 + 0.05 * rs.standard_normal((3, 3, cin, cout))).astype(np.float32)
    scale = float(np.float32(np.abs(x).max() / 127))
    wq, _ = pc.quantize_weight(torch.from_numpy(wt).permute(3, 0, 1, 2))
    return pc.quantize_int8_plain(torch.from_numpy(x), scale), wq


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_halo_split_replay_past_2_24(splits):
    """Past 2^24 the halo's fp32 order differs from the exact sum; every
    split at ky rows keeps it, and so does the plan's own choice."""
    xq, wq = _saturated(512, 16)
    ref = pc.conv2d_int8_halo_sum_plain(xq, wq, 1, 1)
    assert not torch.equal(ref, pc.conv2d_int8_acc_plain(xq, wq, 1, 1).float())
    kc = 512 // pc.K_STEP_BYTES
    per = 3 * kc * -(-3 // splits)
    plan = pc.ConvPlan((6, 4, 1), 64, -(-3 // (per // (3 * kc))), per, 9 * kc, 0)
    assert torch.equal(_replay(xq, wq, 1, 1, plan, True), ref)
    _, own = _plan(_site(1, 4, 6, 512, 16, 3, 1, 1), "halo")
    assert own.splits > 1  # few tiles: the plan splits at ky rows
    assert torch.equal(_replay(xq, wq, 1, 1, own, True), ref)


# ---------------------------------------------------------------------------
# The CUDA contract (CPU tensors exercise the checks)


def test_bf16_cuda_check_refuses_a_misaligned_x():
    x = torch.zeros(1 * 4 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 4, 4, 64)
    w = torch.zeros(64, 3, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pc._check_cuda_bf16(x, w, None)
    pc._check_cuda_bf16(torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16), w, None)


@pytest.mark.parametrize("cin,cout,ok", [(32, 2, True), (160, 200, True), (1920, 640, True),
                                         (16, 64, False), (48, 64, False), (64, 3, False)])
def test_cuda_contract_on_channels(cin, cout, ok):
    """Both kernels take Cin % 32 == 0 (TMA reads 16-byte rows of Cin; a
    k step is 128 bytes) and Cout % 2 == 0 (the epilogue writes pairs)."""
    x = torch.zeros(1, 3, 3, cin, dtype=torch.bfloat16)
    checks = (lambda: pc._check_cuda(x, torch.zeros(cout, 3, 3, cin, dtype=torch.int8),
                                     torch.ones(cout), None),
              lambda: pc._check_cuda_bf16(x, torch.zeros(cout, 3, 3, cin, dtype=torch.bfloat16),
                                          None))
    for check in checks:
        if ok:
            check()
        else:
            with pytest.raises(ValueError):
                check()


def test_plain_replay_operands_are_exact_past_fp32():
    """The replays sum through float64: a k step's partial of 127 * 127 *
    9 * 2560 stays exact."""
    xq = torch.full((1, 3, 3, 2560), 127, dtype=torch.int8)
    wq = torch.full((1, 3, 3, 2560), 127, dtype=torch.int8)
    plan = pc.ConvPlan((1, 1, 1), 64, 2, 90, 180, 0)
    assert _replay(xq, wq, 1, 0, plan, False).item() == 127 * 127 * 9 * 2560
    assert randn(0, 2).shape == (2,)
