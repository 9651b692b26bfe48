"""ctypes bindings for the native host geometry library, with a numpy path
(counterpart of cmtcoop_tpu/data/native.py).

The library is the repository's `native/libcmtcoop_host.so`, which lies
outside the JAX package; if it is missing, the first call builds it with
`make -C native`, as the JAX loader does. Without it (no toolchain, a
library that does not load) every function takes the numpy path of
`data/pipelines/box_np.py`, which computes the same answers. `loaded()` says
which path runs. Replaces the reference's numba dependency for the GT-paste
geometry hot path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from cmtcoop_tpu_torch.data.pipelines import box_np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcmtcoop_host.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.points_in_rbbox.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.points_in_rbbox.restype = None
    lib.box_collision_test.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.box_collision_test.restype = None
    lib.remove_points_in_boxes.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.remove_points_in_boxes.restype = ctypes.c_int64
    _lib = lib
    return lib


def loaded() -> bool:
    """True when the native library is loaded (built first if missing)."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None or len(points) == 0 or len(boxes) == 0:
        return box_np.points_in_rbbox(points, boxes)
    pts = np.ascontiguousarray(points, np.float32)
    bxs = np.ascontiguousarray(boxes[:, :7], np.float32)
    out = np.zeros((len(pts), len(bxs)), np.uint8)
    lib.points_in_rbbox(
        _fptr(pts), len(pts), pts.shape[1], _fptr(bxs), len(bxs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def box_collision_test(boxes_a: np.ndarray,
                       boxes_b: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None or len(boxes_a) == 0 or len(boxes_b) == 0:
        return box_np.box_collision_test(boxes_a, boxes_b)
    a = np.ascontiguousarray(boxes_a[:, :7], np.float32)
    b = np.ascontiguousarray(boxes_b[:, :7], np.float32)
    out = np.zeros((len(a), len(b)), np.uint8)
    lib.box_collision_test(
        _fptr(a), len(a), _fptr(b), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def remove_points_in_boxes(points: np.ndarray,
                           boxes: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None or len(points) == 0 or len(boxes) == 0:
        if len(points) and len(boxes):
            inside = box_np.points_in_rbbox(points, boxes).any(-1)
            return points[~inside]
        return points
    pts = np.ascontiguousarray(points, np.float32).copy()
    bxs = np.ascontiguousarray(boxes[:, :7], np.float32)
    n = lib.remove_points_in_boxes(
        _fptr(pts), len(pts), pts.shape[1], _fptr(bxs), len(bxs))
    return pts[:n]
