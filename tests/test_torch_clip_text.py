"""The port's CLIP text tower (d3roma_tpu_torch/models/clip_text.py) against
the JAX package's on the CPU: one set of numpy-seeded weights carried into
both through models/convert.py, a tiny tower (2 layers, 16 wide, 2 heads),
with each activation. The last hidden state agrees within CLIP_ATOL (fp32
on both sides, sums in another order); the empty prompt's ids are the JAX
package's; the weight bridge round-trips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3roma_tpu.models.clip_text import CLIPTextConfig as JaxConfig
from d3roma_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from d3roma_tpu.models.clip_text import empty_prompt_tokens as jax_empty_prompt_tokens
from d3roma_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, empty_prompt_tokens
from d3roma_tpu_torch.models.convert import clip_text_to_flax, flax_clip_text_to_torch
from torch_port_utils import random_flax_tree

CLIP_ATOL = 1e-5
TINY = dict(vocab_size=50, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=8)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_jax(act):
    ids = np.array([[3, 17, 42, 49, 0], [9, 9, 1, 2, 48]], np.int32)
    jax_model = JaxCLIP(JaxConfig(**TINY, hidden_act=act))
    params = random_flax_tree(jax_model, 4, jnp.asarray(ids))
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(ids)))
    model = CLIPTextModel(CLIPTextConfig(**TINY, hidden_act=act), device="cpu")
    model.load_state_dict(flax_clip_text_to_torch(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long()).numpy()
    assert out.shape == ref.shape == (2, 5, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=CLIP_ATOL)
    # the causal mask: the first token sees only itself
    with torch.no_grad():
        first = model(torch.from_numpy(ids[:, :1]).long()).numpy()
    np.testing.assert_allclose(first[:, 0], out[:, 0], rtol=0, atol=CLIP_ATOL)
    # the bridge back gives the same tree
    back = clip_text_to_flax(model.state_dict())
    flat = {}

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
                flat[f"{path}/{k}"] = 1

    walk(back, params)
    assert len(flat) == len(model.state_dict())


def test_empty_prompt_tokens():
    for n in (2, 5):
        ours, theirs = empty_prompt_tokens(n), jax_empty_prompt_tokens(n)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    assert empty_prompt_tokens().tolist() == [[49406, 49407]]
