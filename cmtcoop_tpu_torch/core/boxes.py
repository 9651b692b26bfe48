"""3D box math (counterpart of cmtcoop_tpu/core/boxes.py), the eval and
train subset.

Box layout: box9 = (cx, cy, cz, w, l, h, yaw, vx, vy), cz at the box center;
the 10-dim regression code is (cx, cy, cz, log w, log l, log h, sin yaw,
cos yaw, vx, vy).
"""
from __future__ import annotations

import torch

from cmtcoop_tpu_torch.utils.constants import constant


def normalize_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """box9/box7 -> 10/8-dim regression code: centers pass through, sizes
    go to log space, yaw to (sin, cos), velocity passes through."""
    yaw = boxes[..., 6:7]
    parts = [boxes[..., 0:3], torch.log(boxes[..., 3:6]), torch.sin(yaw),
             torch.cos(yaw)]
    if boxes.shape[-1] > 7:
        parts.append(boxes[..., 7:9])
    return torch.cat(parts, dim=-1)


def denormalize_bbox(code: torch.Tensor) -> torch.Tensor:
    """10/8-dim regression code -> box9/box7: sizes exp'd back,
    yaw = atan2(sin, cos)."""
    parts = [code[..., 0:3], torch.exp(code[..., 3:6]),
             torch.atan2(code[..., 6:7], code[..., 7:8])]
    if code.shape[-1] > 8:
        parts.append(code[..., 8:10])
    return torch.cat(parts, dim=-1)


def gravity_to_bottom_center(boxes: torch.Tensor) -> torch.Tensor:
    """Shift z from the box center to the box bottom (cz -= h/2)."""
    cz = boxes[..., 2:3] - boxes[..., 5:6] * 0.5
    return torch.cat([boxes[..., 0:2], cz, boxes[..., 3:]], dim=-1)


def normalize_01(xyz: torch.Tensor, pc_range) -> torch.Tensor:
    """Map metric (x, y, z) into [0, 1]^3 using the point-cloud range."""
    lo = constant(pc_range[:3], xyz.dtype, xyz.device)
    hi = constant(pc_range[3:], xyz.dtype, xyz.device)
    return (xyz - lo) / (hi - lo)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Clamped logit, as mmdet's `inverse_sigmoid`."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))
