"""Host-side (numpy) box/point geometry for the data pipeline (a copy of
cmtcoop_tpu/data/pipelines/box_np.py: the port imports nothing of the JAX
package, so it keeps its own).

Numpy mirror of the box helpers of `core/boxes.py` plus the GT-paste
geometry the reference gets from mmdet3d's numba ops
(`box_np_ops.points_in_rbbox`, `box_collision_test` — SURVEY §2.2). Boxes
are bottom-centered box9 (cx, cy, cz_bottom, w, l, h, yaw, vx, vy) matching
LiDARInstance3DBoxes storage.
"""
from __future__ import annotations

import numpy as np


def rot_mat_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def rotate_points(points: np.ndarray, angle: float) -> np.ndarray:
    """CCW rotation around +z of (N, 3+) points (mmdet3d rotate)."""
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot_mat_z(angle).T
    return out


def rotate_boxes(boxes: np.ndarray, angle: float) -> np.ndarray:
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ rot_mat_z(angle).T
    out[:, 6] += angle
    if boxes.shape[1] > 7:
        out[:, 7:9] = boxes[:, 7:9] @ rot_mat_z(angle)[:2, :2].T
    return out


def scale_points(points: np.ndarray, scale: float) -> np.ndarray:
    out = points.copy()
    out[:, :3] *= scale
    return out


def scale_boxes(boxes: np.ndarray, scale: float) -> np.ndarray:
    out = boxes.copy()
    out[:, :6] *= scale
    if boxes.shape[1] > 7:
        out[:, 7:9] *= scale
    return out


def translate_points(points: np.ndarray, t) -> np.ndarray:
    out = points.copy()
    out[:, :3] += np.asarray(t, np.float32)
    return out


def translate_boxes(boxes: np.ndarray, t) -> np.ndarray:
    out = boxes.copy()
    out[:, :3] += np.asarray(t, np.float32)
    return out


def transform_points(points: np.ndarray, mat4: np.ndarray) -> np.ndarray:
    out = points.copy()
    out[:, :3] = points[:, :3] @ mat4[:3, :3].T + mat4[:3, 3]
    return out


def corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7+) -> (N, 4, 2) BEV corners."""
    n = len(boxes)
    w, l, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    sx = np.stack([w, w, -w, -w], -1) * 0.5
    sy = np.stack([l, -l, -l, l], -1) * 0.5
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    cx = boxes[:, 0:1] + sx * c - sy * s
    cy = boxes[:, 1:2] + sx * s + sy * c
    return np.stack([cx, cy], -1)


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+), (M, 7+) bottom-centered -> (N, M) bool membership.

    Equivalent of mmdet3d box_np_ops.points_in_rbbox (numba) in vectorized
    numpy: transform points into each box frame and compare to half-extents.
    """
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(points), len(boxes)), bool)
    centers = boxes[:, :3].copy()
    centers[:, 2] += boxes[:, 5] / 2.0
    d = points[:, None, :3] - centers[None, :, :]  # (N, M, 3)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    local_x = d[..., 0] * c + d[..., 1] * s
    local_y = -d[..., 0] * s + d[..., 1] * c
    half = boxes[:, 3:6] / 2.0
    return ((np.abs(local_x) <= half[None, :, 0]) &
            (np.abs(local_y) <= half[None, :, 1]) &
            (np.abs(d[..., 2]) <= half[None, :, 2]))


def box_collision_test(boxes_a: np.ndarray, boxes_b: np.ndarray):
    """(Na, 7+), (Nb, 7+) -> (Na, Nb) BEV rotated-rectangle overlap.

    SAT on the 4 edge normals of each rectangle pair — the numpy equivalent
    of mmdet3d's numba box_collision_test used by the db-sampler
    (dbsampler.py:246-257).
    """
    na, nb = len(boxes_a), len(boxes_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), bool)
    ca = corners_bev(boxes_a)  # (Na, 4, 2)
    cb = corners_bev(boxes_b)

    def axes(corners):
        e = np.roll(corners, -1, axis=1) - corners  # (N, 4, 2)
        n = np.stack([-e[..., 1], e[..., 0]], -1)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(norm, 1e-9)

    axes_all = np.concatenate(
        [np.broadcast_to(axes(ca)[:, None], (na, nb, 4, 2)),
         np.broadcast_to(axes(cb)[None, :], (na, nb, 4, 2))], axis=2)
    # project both corner sets on all 8 candidate separating axes
    proj_a = np.einsum("ijka,ipa->ijkp", axes_all, ca)       # (Na,Nb,8,4)
    proj_b = np.einsum("ijka,jpa->ijkp", axes_all, cb)
    sep = (proj_a.max(-1) < proj_b.min(-1) - 1e-9) | (
        proj_b.max(-1) < proj_a.min(-1) - 1e-9)
    return ~sep.any(-1)
