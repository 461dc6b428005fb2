"""The CLIP text encoder, for the empty-prompt embedding.

Port of `d3roma_tpu/models/clip_text.py`. The reference runs a frozen CLIP
text tower once, on the empty prompt (reference: train.py:825-827,
core/custom_pipelines.py:241-254); the importer bakes that embedding into
the pipeline directory, so inference needs neither the tower nor a
tokenizer. The forward is transformers' CLIPTextModel: token + position
embeddings, a pre-LN causal transformer, a final LayerNorm. The defaults
are SD2.1's OpenCLIP-ViT/H tower. State-dict names are transformers' with
`text_model.` stripped.

Its conventions differ from the UNet's: the GELU is the exact erf form
(SD1.x towers take "quick_gelu", x * sigmoid(1.702 x)), LayerNorm epsilon
is 1e-5, and the causal mask sets the masked scores to -1e9, not -inf.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3roma_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # SD2.1 uses the exact gelu; SD1.x "quick_gelu"


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        d = C // self.heads
        q, k, v = (p(x).reshape(B, N, self.heads, d) for p in (self.q_proj, self.k_proj,
                                                                  self.v_proj))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        scores = torch.where(causal, scores, torch.full_like(scores, -1e9))
        attn = torch.softmax(scores, dim=-1)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, C))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class CLIPTextModel(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in fp32."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(), device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.embeddings = _Embeddings(cfg)
            self.encoder = _Encoder(cfg)
            self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids [B, N] -> last_hidden_state [B, N, hidden_size]."""
        N = input_ids.shape[1]
        pos = torch.arange(N, device=input_ids.device)[None]
        x = self.embeddings.token_embedding(input_ids) + self.embeddings.position_embedding(pos)
        causal = torch.tril(torch.ones((N, N), dtype=torch.bool, device=x.device))[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


def empty_prompt_tokens(max_len: int = 2) -> np.ndarray:
    """Token ids of the empty prompt, [1, max_len] int32: [BOS, EOS].

    The reference tokenizes "" with padding="do_not_pad" (train.py:116-129
    and custom_pipelines.py:241-254), so its text embedding is [1, 2, D] and
    cross-attention attends over two tokens. `max_len` > 2 gives
    CLIPTokenizer's EOS-padded form (SD1.x-style max_length padding, not
    the reference's)."""
    ids = np.full((1, max_len), 49407, np.int32)
    ids[0, 0] = 49406
    return ids
