"""Hard voxelization with static shapes (counterpart of
cmtcoop_tpu/ops/voxelize.py).

One stable sort of the points by voxel id; each voxel slot then takes the
first `max_points` of its points in their original order, and voxels past
`max_voxels` (in sorted (z, y, x) order) are dropped. Empty slots are zero,
their coords -1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cmtcoop_tpu_torch.ops.pillars import INT32_MAX, compute_voxel_coords


class VoxelizationOutput(NamedTuple):
    voxels: torch.Tensor      # (max_voxels, max_points, F)
    coords: torch.Tensor      # (max_voxels, 3) int32 (z, y, x); -1 padding
    num_points: torch.Tensor  # (max_voxels,) int32
    mask: torch.Tensor        # (max_voxels,) bool


def voxelize(points: torch.Tensor, point_mask: torch.Tensor, *, voxel_size,
             pc_range, grid_size, max_points: int = 10,
             max_voxels: int = 120000, return_stats: bool = False):
    """Points (N, F), mask (N,) -> `VoxelizationOutput` (grid_size is
    (X, Y, Z) cells). With `return_stats`, also scalar int64 telemetry:
    n_voxels_raw (distinct voxels) and n_voxels_dropped (past
    `max_voxels`)."""
    n = points.shape[0]
    dev = points.device
    zyx, valid = compute_voxel_coords(points, point_mask, voxel_size,
                                      pc_range, grid_size)
    gx, gy, _ = grid_size
    lin = (zyx[:, 0] * gy + zyx[:, 1]) * gx + zyx[:, 2]
    slin, order = torch.sort(torch.where(valid, lin, INT32_MAX), stable=True)
    spts = points[order]
    szyx = zyx[order]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      slin[1:] != slin[:-1]]) & (slin != INT32_MAX)
    vrank = torch.where(slin == INT32_MAX, INT32_MAX,
                        torch.cumsum(head.long(), 0) - 1)
    n_voxels = head.sum()
    # vrank is sorted: each slot's run of points by binary search
    slots = torch.arange(max_voxels, device=dev)
    starts = torch.searchsorted(vrank, slots)
    ends = torch.searchsorted(vrank, slots, right=True)
    vmask = slots < n_voxels
    counts = torch.where(vmask, (ends - starts).clamp(max=max_points), 0)
    idx = (starts[:, None] + torch.arange(max_points, device=dev)).clamp(
        max=n - 1)
    in_voxel = torch.arange(max_points, device=dev) < counts[:, None]
    voxels = torch.where(in_voxel[..., None], spts[idx], 0.0)
    coords = torch.where(vmask[:, None], szyx[starts.clamp(max=n - 1)], -1)
    out = VoxelizationOutput(voxels, coords.to(torch.int32),
                             counts.to(torch.int32), vmask)
    if not return_stats:
        return out
    return out, dict(n_voxels_raw=n_voxels,
                     n_voxels_dropped=(n_voxels - max_voxels).clamp(min=0))


def hard_simple_vfe(vox: VoxelizationOutput) -> torch.Tensor:
    """(max_voxels, F) mean of each voxel's points (mmdet3d
    HardSimpleVFE); empty slots zero."""
    s = vox.voxels.sum(dim=1)
    n = vox.num_points.clamp(min=1).to(s.dtype)
    return torch.where(vox.mask[:, None], s / n[:, None], 0.0)
