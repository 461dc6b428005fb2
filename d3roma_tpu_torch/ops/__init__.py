"""Diffusion numerics and the hand-written kernels of the port."""
