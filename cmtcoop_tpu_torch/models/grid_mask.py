"""GridMask image augmentation (counterpart of
cmtcoop_tpu/models/grid_mask.py), at the reference's settings: use_h and
use_w, ratio 0.5, mode 1, prob 0.7, rotate 1 (the rotation is by
randint(1) = 0 degrees, a no-op, so it is left out).

The draws are explicit: `grid_mask_draws` takes them from a generator on
the host, and `grid_mask` takes them as numbers, so a test can feed it the
JAX package's `jax.random` draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GridMaskDraws(NamedTuple):
    apply_u: float  # applied when < prob
    d: int          # band period, in [2, min(H, W))
    sx: int         # band offsets, in [0, d)
    sy: int


def grid_mask_draws(generator: torch.Generator, h: int,
                    w: int) -> GridMaskDraws:
    """One image batch's draws from a (CPU) generator."""
    u = float(torch.rand((), generator=generator))
    d, ox, oy = (int(x) for x in torch.cat([
        torch.randint(2, min(h, w), (1,), generator=generator),
        torch.randint(0, 1 << 30, (2,), generator=generator)]))
    return GridMaskDraws(u, d, ox % d, oy % d)


def grid_mask(imgs: torch.Tensor, draws: GridMaskDraws, prob: float = 0.7,
              ratio: float = 0.5, mode: int = 1) -> torch.Tensor:
    """GridMask on (N, H, W, C) images: bands of width l = round(d * ratio)
    every d pixels from offsets (sx, sy) along both axes; mode 1 (the
    reference's inverted mask) keeps the bands and zeroes the rest, mode 0
    the opposite. Identity unless draws.apply_u < prob."""
    if not draws.apply_u < prob:
        return imgs
    _, h, w, _ = imgs.shape
    d = draws.d
    l = max(int(d * ratio + 0.5), 1)
    ys = torch.arange(h, device=imgs.device)[:, None]
    xs = torch.arange(w, device=imgs.device)[None, :]
    in_band = (((ys - draws.sy) % d) < l) | (((xs - draws.sx) % d) < l)
    keep = in_band if mode == 1 else ~in_band
    return imgs * keep[None, :, :, None].to(imgs.dtype)
