"""Optional point-loading utilities (a copy of
cmtcoop_tpu/data/pipelines/loading_utils.py; reference
datasets/pipelines/loading_utils.py — MVP virtual points + beam reduction;
off in all shipped configs but part of the capability surface)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def reduce_lidar_beams(points: np.ndarray, num_beams: int,
                       total_beams: int = 32,
                       fov_down: float = -30.0,
                       fov_up: float = 10.0) -> np.ndarray:
    """Subsample a rotating-lidar cloud to `num_beams` elevation rings
    (loading_utils.py:56-108 capability): bin points by elevation angle and
    keep every (total/num)-th ring."""
    xyz = points[:, :3]
    r = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.degrees(np.arctan2(xyz[:, 2], np.maximum(r, 1e-6)))
    fov = fov_up - fov_down
    ring = np.clip(((elev - fov_down) / fov * total_beams).astype(int),
                   0, total_beams - 1)
    keep_every = max(total_beams // max(num_beams, 1), 1)
    return points[ring % keep_every == 0]


def load_virtual_points(path: str, dims: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
    """MVP/point-painting virtual points loader (loading_utils.py:8-54):
    .npy dict with 'virtual_points' / 'real_points' concatenated."""
    data = np.load(path, allow_pickle=True)
    if hasattr(data, "item"):
        data = data.item()
    parts = []
    for key in ("real_points", "virtual_points"):
        if key in data:
            parts.append(np.asarray(data[key], np.float32))
    out = np.concatenate(parts) if parts else np.asarray(data, np.float32)
    if dims is not None:
        out = out[:, list(dims)]
    return out
