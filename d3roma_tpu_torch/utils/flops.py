"""Analytic model-FLOPs accounting for the flagship pipeline.

A copy of `d3roma_tpu/utils/flops.py` (pure Python; the port imports
nothing of the JAX package): theoretical forward FLOPs (2 MACs for every
conv, dense and attention contraction) walked over the module graph of the
UNet and the VAE, the MFU convention: kernel padding waste and elementwise
traffic are not counted. The counts are the JAX package's, unchanged; the
peaks are the H100 SXM's (NVIDIA's data sheet, dense), in place of the
TPU's.

Used by the port's bench (`d3roma_tpu_torch/bench.py`) for TFLOP/frame,
sustained TFLOP/s and the share of the bf16 and int8 peaks.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM dense tensor-core peaks (data sheet; at the 700 W limit)
H100_BF16_PEAK = 989.4e12
H100_INT8_PEAK = 1978.9e12


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * h * w * cin * cout * k * k


def dense_flops(n: int, cin: int, cout: int) -> int:
    return 2 * n * cin * cout


def resnet_block_flops(h: int, w: int, cin: int, cout: int,
                       temb_dim: int = 0) -> int:
    """layers.ResnetBlock2D: conv1 (cin->cout), conv2 (cout->cout),
    1x1 shortcut when cin != cout, optional time-emb projection."""
    f = conv_flops(h, w, cin, cout) + conv_flops(h, w, cout, cout)
    if cin != cout:
        f += conv_flops(h, w, cin, cout, k=1)
    if temb_dim:
        f += dense_flops(1, temb_dim, cout)
    return f


def attention_flops(n: int, inner: int, m: int = None,
                    kv_dim: int = None) -> int:
    """Multi-head attention over n queries / m keys: q/k/v/out projections
    + the two score/value contractions (2·n·m·inner each)."""
    m = n if m is None else m
    kv_dim = inner if kv_dim is None else kv_dim
    proj = (dense_flops(n, inner, inner)          # q
            + 2 * dense_flops(m, kv_dim, inner)   # k, v
            + dense_flops(n, inner, inner))       # out
    return proj + 2 * (2 * n * m * inner)


def transformer2d_flops(h: int, w: int, c: int, inner: int,
                        ctx_len: int, ctx_dim: int, depth: int = 1) -> int:
    """layers.Transformer2D: proj_in/out + depth x (self-attn, cross-attn,
    GEGLU feed-forward with 4x mult -> 8x-wide first projection)."""
    n = h * w
    f = dense_flops(n, c, inner) + dense_flops(n, inner, c)
    per_block = (
        attention_flops(n, inner)
        + attention_flops(n, inner, m=ctx_len, kv_dim=ctx_dim)
        + dense_flops(n, inner, 8 * inner)   # GEGLU proj (h + gate)
        + dense_flops(n, 4 * inner, inner)   # out proj
    )
    return f + depth * per_block


def unet2d_condition_flops(
    h: int, w: int,
    in_channels: int = 4,
    out_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block: int = 2,
    attention_head_dim: int = 64,
    cross_attention_dim: int = 1024,
    ctx_len: int = 77,
) -> int:
    """Per-sample forward FLOPs, walking models/unet2d_condition.py's
    graph exactly (incl. the up-path skip-concat input widths)."""
    c0 = block_out_channels[0]
    temb = 4 * c0
    total = dense_flops(1, c0, temb) + dense_flops(1, temb, temb)
    total += conv_flops(h, w, in_channels, c0)

    def inner_for(ch):
        return max(1, ch // attention_head_dim) * attention_head_dim

    # ---- down ----  (skips record (channels, h, w): the up path resnets
    # run at the POPPED skip's resolution and the upsample targets the
    # NEXT skip's size — unet2d_condition.py:144 uses out_hw=skips[-1];
    # doubling h,w instead overcounts odd latent dims, e.g. 45x80 -> the
    # widest up blocks costed at 48x80)
    skips = [(c0, h, w)]
    cur = c0
    for i, (btype, ch) in enumerate(zip(down_block_types, block_out_channels)):
        is_last = i == len(block_out_channels) - 1
        for _ in range(layers_per_block):
            total += resnet_block_flops(h, w, cur, ch, temb)
            cur = ch
            if btype == "CrossAttnDownBlock2D":
                total += transformer2d_flops(h, w, ch, inner_for(ch),
                                             ctx_len, cross_attention_dim)
            skips.append((ch, h, w))
        if not is_last:
            total += conv_flops((h + 1) // 2, (w + 1) // 2, ch, ch)  # stride-2
            h, w = (h + 1) // 2, (w + 1) // 2
            skips.append((ch, h, w))

    # ---- mid ----
    mid = block_out_channels[-1]
    total += resnet_block_flops(h, w, cur, mid, temb)
    total += transformer2d_flops(h, w, mid, inner_for(mid),
                                 ctx_len, cross_attention_dim)
    total += resnet_block_flops(h, w, mid, mid, temb)
    cur = mid

    # ---- up ----
    rev = tuple(reversed(block_out_channels))
    for i, btype in enumerate(up_block_types):
        ch = rev[i]
        is_last = i == len(up_block_types) - 1
        for _ in range(layers_per_block + 1):
            skip, h, w = skips.pop()
            total += resnet_block_flops(h, w, cur + skip, ch, temb)
            cur = ch
            if btype == "CrossAttnUpBlock2D":
                total += transformer2d_flops(h, w, ch, inner_for(ch),
                                             ctx_len, cross_attention_dim)
        if not is_last:
            h, w = skips[-1][1], skips[-1][2]  # upsample to the next skip's size
            total += conv_flops(h, w, ch, ch)  # Upsample2D conv after resize

    total += conv_flops(h, w, block_out_channels[0], out_channels)
    return total


def unet2d_condition_shallow_flops(
    h: int, w: int,
    in_channels: int = 4,
    out_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block: int = 2,
    attention_head_dim: int = 64,
    cross_attention_dim: int = 1024,
    ctx_len: int = 77,
    cache_depth: int = 1,
) -> int:
    """FLOPs of the DeepCache shallow (cached-trunk) pass at the given
    ``cache_depth``: time embedding + conv_in + down blocks [0, depth)
    (with their downsamples except the last's) + the trailing `depth` up
    blocks (the first entered by the cached trunk) + conv_out — the exact
    subgraph of models/unet2d_condition.py's ``cached_trunk`` path."""
    c0 = block_out_channels[0]
    temb = 4 * c0
    total = dense_flops(1, c0, temb) + dense_flops(1, temb, temb)
    total += conv_flops(h, w, in_channels, c0)

    def inner_for(ch):
        return max(1, ch // attention_head_dim) * attention_head_dim

    depth = int(cache_depth)
    n_up = len(up_block_types)
    assert 1 <= depth <= n_up - 1, depth

    # down blocks [0, depth); downsample after all but the last of them
    skips = [(c0, h, w)]
    cur = c0
    for i in range(depth):
        btype, ch = down_block_types[i], block_out_channels[i]
        for _ in range(layers_per_block):
            total += resnet_block_flops(h, w, cur, ch, temb)
            cur = ch
            if btype == "CrossAttnDownBlock2D":
                total += transformer2d_flops(h, w, ch, inner_for(ch),
                                             ctx_len, cross_attention_dim)
            skips.append((ch, h, w))
        if i < depth - 1:
            total += conv_flops((h + 1) // 2, (w + 1) // 2, ch, ch)
            h, w = (h + 1) // 2, (w + 1) // 2
            skips.append((ch, h, w))

    # the trailing `depth` up blocks, the first entered by the trunk
    rev = tuple(reversed(block_out_channels))
    refresh_from = n_up - depth
    h, w = skips[-1][1], skips[-1][2]  # trunk is at the deepest skip's size
    cur = rev[refresh_from - 1] if refresh_from >= 1 else block_out_channels[-1]
    for i in range(refresh_from, n_up):
        btype, ch = up_block_types[i], rev[i]
        for _ in range(layers_per_block + 1):
            skip, h, w = skips.pop()
            total += resnet_block_flops(h, w, cur + skip, ch, temb)
            cur = ch
            if btype == "CrossAttnUpBlock2D":
                total += transformer2d_flops(h, w, ch, inner_for(ch),
                                             ctx_len, cross_attention_dim)
        if i < n_up - 1:
            h, w = skips[-1][1], skips[-1][2]
            total += conv_flops(h, w, ch, ch)  # Upsample2D conv after resize

    total += conv_flops(h, w, block_out_channels[0], out_channels)
    return total


def vae_encoder_flops(
    h: int, w: int,
    in_channels: int = 3,
    latent_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
    layers_per_block: int = 2,
) -> int:
    """models/vae.py Encoder (+ the 1x1 quant_conv)."""
    total = conv_flops(h, w, in_channels, block_out_channels[0])
    cur = block_out_channels[0]
    for i, ch in enumerate(block_out_channels):
        is_last = i == len(block_out_channels) - 1
        for _ in range(layers_per_block):
            total += resnet_block_flops(h, w, cur, ch)
            cur = ch
        if not is_last:
            h, w = (h + 1) // 2, (w + 1) // 2
            total += conv_flops(h, w, ch, ch)
    top = block_out_channels[-1]
    total += resnet_block_flops(h, w, top, top)
    total += attention_flops(h * w, top)  # mid self-attention, 1 head
    total += resnet_block_flops(h, w, top, top)
    total += conv_flops(h, w, top, 2 * latent_channels)
    total += conv_flops(h, w, 2 * latent_channels, 2 * latent_channels, k=1)
    return total


def vae_decoder_flops(
    h: int, w: int,  # LATENT height/width
    out_channels: int = 3,
    latent_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
    layers_per_block: int = 3,
) -> int:
    """models/vae.py Decoder (+ the 1x1 post_quant_conv)."""
    rev = tuple(reversed(block_out_channels))
    total = conv_flops(h, w, latent_channels, latent_channels, k=1)
    total += conv_flops(h, w, latent_channels, rev[0])
    total += resnet_block_flops(h, w, rev[0], rev[0])
    total += attention_flops(h * w, rev[0])
    total += resnet_block_flops(h, w, rev[0], rev[0])
    cur = rev[0]
    for i, ch in enumerate(rev):
        is_last = i == len(rev) - 1
        for _ in range(layers_per_block):
            total += resnet_block_flops(h, w, cur, ch)
            cur = ch
        if not is_last:
            h, w = h * 2, w * 2
            total += conv_flops(h, w, ch, ch)
    total += conv_flops(h, w, rev[-1], out_channels)
    return total


def latent_pipeline_flops_per_frame(
    H: int, W: int, steps: int, n_conds: int = 2, in_channels: int = 12,
    cache_interval: int = 1, cache_schedule: str = None,
    cache_depth: int = 1,
) -> dict:
    """Model FLOPs per FRAME of the flagship latent pipeline at image size
    HxW: one VAE encode per condition, `steps` UNet forwards at the /8
    latent size, one final decode.

    ``cache_interval=k > 1`` counts the DeepCache step pattern (the FLOPs
    actually executed): groups of one full pass + (k-1) shallow cached
    passes, remainder steps full — keeping bench MFU honest under the
    cached schedule. ``cache_schedule`` (an F/S pattern string,
    pipelines/sampling.parse_cache_schedule) overrides the uniform
    interval; ``cache_depth`` selects the shallow pass's depth."""
    h, w = H // 8, W // 8
    unet = unet2d_condition_flops(h, w, in_channels=in_channels)
    enc = vae_encoder_flops(H, W)
    dec = vae_decoder_flops(h, w)
    out = {"unet_per_step": unet, "vae_encode": enc, "vae_decode": dec}
    if cache_schedule is not None:
        pattern = cache_schedule.strip().upper()
        assert len(pattern) == steps and not set(pattern) - {"F", "S"}, \
            cache_schedule
        n_shallow = pattern.count("S")
        n_full = steps - n_shallow
    else:
        k = max(1, int(cache_interval))
        groups, rem = divmod(steps, k)
        n_full, n_shallow = groups + rem, groups * (k - 1)
    if n_shallow:
        shallow = unet2d_condition_shallow_flops(
            h, w, in_channels=in_channels, cache_depth=cache_depth)
        out["unet_shallow_per_step"] = shallow
        out["total"] = (n_full * unet + n_shallow * shallow
                        + n_conds * enc + dec)
    else:
        out["total"] = steps * unet + n_conds * enc + dec
    return out
