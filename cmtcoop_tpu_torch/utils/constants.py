"""Tensors of Python constants, built once per values, dtype and device.

`torch.tensor(values, device=cuda)` copies from pageable host memory and so
waits for the card; a frame that builds its constants anew waits once per
constant, and a CUDA graph cannot capture it at all. `constant` builds each
one on its first call and hands the same tensor to every later caller, who
must not write to it.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode, so a
    # later autograd caller may use it
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)`, cached."""
    return _constant(tuple(values), dtype, torch.device(device))
