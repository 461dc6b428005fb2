"""The host plan of the CUDA int8 wide attention kernel (head widths 256 and
512; ops/kernels/attention.py::wide_plan) and a plain-torch model of the
kernel's walk (csrc/attention_int8.cu, namespace wide), on the CPU: 64-row
query blocks of D / 128 consumer warpgroups, each the owner of a 128-wide
slice of O and of the scores of its share of every 128-key tile; pass 1's
integer row max per warpgroup, masked past M and combined across them;
pass 2's round(127 exp(s - max)) written by the warpgroups into one shared
P tile that every O slice reads. The model is held against the JAX Pallas
kernel in interpret mode, its int32 sums against the plain version's, and
the plan's ring of K and V units (each refilled by the last of its readers
to hand it back) is replayed to show that no warpgroup waits for good."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.ops.pallas import attention as jax_attention
from d3roma_tpu_torch.ops.kernels import attention as pa
from d3roma_tpu_torch.ops.kernels.quantize import fp32
from torch_port_utils import randn

# as tests/test_torch_attention_rows.py: exact integer sums on both sides;
# exp in the last place and the denominator's order move round(127 p) by one
# quantum for a few keys
INT8_TOL = 2e-3
INT_MIN = -2**31


def _wide_model(qq, kq, vq, sq, sk, sv, scale, dtype):
    """The kernel's walk. qq [B, N, H, D], kq and vq [B, M, H, D] (integers
    as fp32); sq, sk, sv [B, H]. Returns (out [B, N, H, D] in `dtype`, the
    int32 sums of P V [B, N, H, D] as float64, the integer row max [B, N,
    H])."""
    b, n, h, d = qq.shape
    m = kq.shape[1]
    plan = pa.wide_plan(b, n, m, h, d, -(-m // 64) * 64)
    groups, gk = plan.groups, plan.group_keys
    assert groups * gk == pa.WIDE_KEYS and groups * 128 == d
    out = torch.empty((b, n, h, d), dtype=dtype)
    sums = torch.empty((b, n, h, d), dtype=torch.float64)
    row_max = torch.empty((b, n, h))
    sv127 = pa.ieee_div(sv, 127.0)
    for bi in range(plan.grid[2]):
        for hi in range(plan.grid[1]):
            c = (torch.tensor(fp32(scale)) * sq[bi, hi]) * sk[bi, hi]
            for blk in range(plan.grid[0]):
                rows = slice(blk * pa.WIDE_ROWS, min((blk + 1) * pa.WIDE_ROWS, n))
                q = qq[bi, rows, hi].double()

                def scores(t, g):
                    """S of warpgroup g's keys of tile t, and how many are valid."""
                    k0 = t * pa.WIDE_KEYS + g * gk
                    keys = kq[bi, k0:k0 + gk, hi].double()
                    s = torch.zeros((q.shape[0], gk), dtype=torch.float64)
                    s[:, :keys.shape[0]] = q @ keys.t()  # TMA's zero fill past M
                    return s.float(), m - k0

                # pass 1: each warpgroup's max of its valid keys, then the block's
                maxes = torch.full((groups, q.shape[0]), float(INT_MIN))
                for t in range(plan.key_tiles):
                    for g in range(groups):
                        s, valid = scores(t, g)
                        if valid > 0:
                            maxes[g] = torch.maximum(maxes[g], s[:, :valid].max(dim=1).values)
                mx = maxes.max(dim=0).values
                m_row = mx * c
                # pass 2: the P tile from every warpgroup's keys; each O slice
                acc = torch.zeros((q.shape[0], d), dtype=torch.float64)
                denom = torch.zeros((groups, q.shape[0]))
                for t in range(plan.key_tiles):
                    p_tile = torch.zeros((q.shape[0], pa.WIDE_KEYS), dtype=torch.float64)
                    for g in range(groups):
                        s, valid = scores(t, g)
                        p = torch.exp(s * c - m_row[:, None])
                        p[:, max(valid, 0):] = 0.0
                        denom[g] = denom[g] + p.sum(dim=1)
                        p_tile[:, g * gk:(g + 1) * gk] = torch.round(p * 127.0).double()
                    keys = slice(t * pa.WIDE_KEYS, (t + 1) * pa.WIDE_KEYS)
                    v = torch.zeros((pa.WIDE_KEYS, d), dtype=torch.float64)
                    vt = vq[bi, keys, hi].double()
                    v[:vt.shape[0]] = vt  # vt's zero padding past M
                    for g in range(groups):
                        cols = slice(128 * g, 128 * (g + 1))
                        acc[:, cols] = acc[:, cols] + p_tile @ v[:, cols]
                total = denom[0]
                for g in range(1, groups):
                    total = total + denom[g]
                sums[bi, rows, hi] = acc
                row_max[bi, rows, hi] = mx
                out[bi, rows, hi] = ((acc.float() * sv127[bi, hi]) / total[:, None]).to(dtype)
    return out, sums, row_max


def _quantized(q, k, v):
    return [pa.quantize_per_head(torch.from_numpy(t)) for t in (q, k, v)]


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 200, 150, 1, 512),   # N and M off the 64-row blocks and the 128-key tiles
    (1, 90, 90, 2, 256),
    (1, 70, 1, 1, 512),      # one key: three of the four warpgroups see none
])
def test_wide_model_matches_pallas_int8_kernel(b, n, m, h, d):
    q, k, v = (randn(seed, b, length, h, d) for seed, length in ((31, n), (32, m), (33, m)))
    ref = np.asarray(jax_attention.mha_attention(*map(jnp.asarray, (q, k, v)), quant="int8",
                                                 interpret=True))
    (qq, sq), (kq, sk), (vq, sv) = _quantized(q, k, v)
    out, sums, row_max = _wide_model(qq.float(), kq.float(), vq.float(), sq, sk, sv,
                                     1.0 / math.sqrt(d), torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=INT8_TOL * np.abs(ref).max(), rtol=0)
    # the int32 sums and the integer row max are those of the whole key row
    s = torch.einsum("bnhd,bmhd->bhnm", qq.double(), kq.double())
    assert torch.equal(row_max, s.amax(dim=-1).permute(0, 2, 1).float())
    c = (torch.tensor(fp32(1.0 / math.sqrt(d))) * sq) * sk
    p = torch.exp(s.float() * c[..., None, None] - (row_max.permute(0, 2, 1) * c[..., None])[
        ..., None])
    direct = torch.einsum("bhnm,bmhd->bnhd", torch.round(p * 127.0).double(), vq.double())
    assert torch.equal(sums, direct)


def test_wide_model_in_bf16_matches_the_plain_version():
    """The model with the kernel's bf16 output against mha_attention_int8's
    plain version (the CPU side of the wrapper): one bf16 rounding apart."""
    b, n, m, h, d = 2, 130, 200, 1, 512
    q, k, v = (torch.from_numpy(randn(seed, b, length, h, d)).to(torch.bfloat16)
               for seed, length in ((41, n), (42, m), (43, m)))
    (qq, sq), (kq, sk), (vq, sv) = (pa.quantize_per_head(t) for t in (q, k, v))
    out, _, _ = _wide_model(qq.float(), kq.float(), vq.float(), sq, sk, sv,
                            1.0 / math.sqrt(d), torch.bfloat16)
    ref = pa.mha_attention_int8(q, k, v).float()
    assert (out.float() - ref).abs().max() <= INT8_TOL * ref.abs().max()


def _replay_ring(plan):
    """Replay the warpgroups' waits and hand-backs (attention_int8.cu,
    mha_int8_wide_kernel) through plan.slots slots: units 0 .. slots - 1
    are loaded first, unit u + slots once every reader of unit u has handed
    it back, and the warpgroups meet on a barrier once a tile in pass 2.
    Returns the number of units loaded; raises on a wait that never ends."""
    groups, t_n, slots = plan.groups, plan.key_tiles, plan.slots
    readers = groups // 2

    def half(g):
        return g // (groups // 2)

    # each warpgroup's program: ("wait", unit), ("free", unit), ("bar", i)
    programs = []
    for g in range(groups):
        prog = []
        for t in range(t_n):
            u = 2 * t + half(g)
            prog += [("wait", u), ("free", u)]
        u2 = 2 * t_n
        for t in range(t_n):
            uk, uv = u2 + 4 * t + half(g), u2 + 4 * t + 2 + half(g)
            prog.append(("wait", uk))
            if t > 0:
                prog.append(("free", uv - 4))
            prog += [("free", uk), ("bar", t), ("wait", uv)]
        prog.append(("free", u2 + 4 * (t_n - 1) + 2 + half(g)))
        programs.append(prog)
    bars = [{arg: i for i, (op, arg) in enumerate(prog) if op == "bar"} for prog in programs]
    pcs = [0] * groups
    loaded = set(range(min(slots, plan.units)))
    freed = {}  # unit -> hand-backs
    while True:
        progress = False
        for g in range(groups):
            while pcs[g] < len(programs[g]):
                op, arg = programs[g][pcs[g]]
                if op == "wait" and arg not in loaded:
                    break
                if op == "bar" and not all(pcs[o] >= bars[o][arg] for o in range(groups)):
                    break
                if op == "free":
                    freed[arg] = freed.get(arg, 0) + 1
                    assert freed[arg] <= readers
                    if freed[arg] == readers and arg + slots < plan.units:
                        loaded.add(arg + slots)  # the last reader refills the slot
                pcs[g] += 1
                progress = True
        if all(pc == len(p) for pc, p in zip(pcs, programs)):
            return len(loaded)
        if not progress:
            raise AssertionError(f"the ring stalls: units loaded {loaded}, programs at {pcs}")


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 3600, 3600, 1, 512),   # the VAE's decode
    (4, 3600, 3600, 1, 512),   # and encode
    (1, 200, 150, 1, 512),
    (1, 90, 90, 2, 256),
    (1, 70, 1, 1, 512),
])
def test_wide_plan(b, n, m, h, d):
    m_pad = -(-m // 64) * 64
    plan = pa.wide_plan(b, n, m, h, d, m_pad)
    assert plan.grid == (-(-n // 64), h, b)
    assert plan.groups == d // 128 and plan.threads == 128 * plan.groups
    assert plan.group_keys * plan.groups == 128
    assert plan.key_tiles * 128 >= m > (plan.key_tiles - 1) * 128
    assert plan.last_keys + 128 * (plan.key_tiles - 1) == m
    assert plan.units == 6 * plan.key_tiles and plan.unit_bytes == 64 * d
    # K-major boxes of 128 bytes x 64 rows of q and k; vt's boxes of 128 keys
    # x D / 2 rows (a V half)
    assert plan.q_map == ((d, h, b * n), (128, 1, 64))
    assert plan.k_map == ((d, h, b * m), (128, 1, 64))
    assert plan.v_map == ((m_pad, b * h * d), (128, d // 2))
    # a K half (D / 128 boxes) and a V half (one) fill one unit
    assert (d // 128) * 64 * 128 == plan.unit_bytes == 128 * (d // 2)
    assert plan.smem_bytes <= 232448  # a block's shared memory on the H100
    assert _replay_ring(plan) == plan.units


def test_wide_plan_at_the_vae_shapes():
    decode = pa.wide_plan(2, 3600, 3600, 1, 512, 3648)
    assert decode.grid == (57, 1, 2) and decode.slots == 5 and decode.threads == 512
    assert decode.key_tiles == 29 and decode.last_keys == 16
    encode = pa.wide_plan(4, 3600, 3600, 1, 512, 3648)
    assert encode.grid == (57, 1, 4)


@pytest.mark.parametrize("args", [
    (1, 300, 300, 1, 128, 320),    # the rows kernel's width
    (1, 300, 300, 1, 384, 320),    # off the menu
    (1, 300, 300, 1, 512, 256),    # vt shorter than M
    (1, 300, 300, 1, 512, 328),    # a row pitch TMA cannot take
    (0, 300, 300, 1, 512, 320),
])
def test_wide_plan_refuses_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        pa.wide_plan(*args)
