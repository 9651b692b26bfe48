"""PyTorch / CUDA port of cmtcoop_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (`core/`, `ops/`, `models/`, `train/`); the
kernels that the JAX package wrote in Pallas are hand-written CUDA under
`csrc/`, built at first use (`_build.py`). Imports torch, never jax.
"""
