"""Seeded weights, made by the harness on the device in one generator call.

The harness, not the program, makes every value: it takes only the names
and shapes of the program model's state (so that both sides can load the
same tensors) and fills them by one rule, which keeps a deep network's
activations in range with random weights:

- a norm's scale (every 1-D `weight`) in [0.8, 1.2], its shift (the
  1-D `bias` beside it) in [-0.1, 0.1], `running_mean` in [-0.1, 0.1],
  `running_var` in [0.5, 1.5];
- `reference_points.weight` (the head's query anchors) in [0, 1];
- any other weight uniform in +-1/sqrt(fan_in), fan_in its element count
  over its first dimension (output channels, or for the one transposed
  conv, whose input and output widths agree, the same number), and its
  bias alike; `in_proj_bias` in +-0.02.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _bounds(name: str, shape: Tuple[int, ...],
            shapes: Dict[str, Tuple[int, ...]]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    stem = name[:-len(leaf)]
    if leaf == "running_mean":
        return -0.1, 0.1
    if leaf == "running_var":
        return 0.5, 1.5
    if name.endswith("reference_points.weight"):
        return 0.0, 1.0
    if leaf == "weight" and len(shape) == 1:
        return 0.8, 1.2
    if leaf == "bias":
        w = shapes.get(stem + "weight")
        if w is None or len(w) == 1:
            return -0.1, 0.1
        b = 1.0 / math.sqrt(math.prod(w[1:]))
        return -b, b
    if leaf == "in_proj_bias":
        return -0.02, 0.02
    b = 1.0 / math.sqrt(math.prod(shape[1:]))
    return -b, b


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`, every value from one uniform draw
    of a generator on `device` seeded from `seed`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        lo, hi = _bounds(name, shape, shapes)
        out[name] = flat[at:at + n].view(shape).mul_(hi - lo).add_(lo)
        at += n
    return out
