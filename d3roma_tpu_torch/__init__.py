"""d3roma_tpu_torch — the PyTorch/CUDA port of d3roma_tpu.

The JAX package `d3roma_tpu` is the reference; this package mirrors its
module names (`ops/schedules.py`, `models/layers.py`,
`pipelines/pipeline.py`, ...) so each counterpart is easy to find. Plain
tensor code is PyTorch; each Pallas kernel of the JAX package on the ported
path is a hand-written CUDA kernel for Hopper (`csrc/`, built with nvcc at
first use and bound with ctypes, see `ops/kernels/_build.py`).

Public functions keep the JAX layouts: images and latents NHWC, attention
q/k/v as [B, N, H, D]. Entry points run on CUDA unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own.

This package imports torch and numpy only — never jax, flax or d3roma_tpu.
"""

__version__ = "0.1.0"
