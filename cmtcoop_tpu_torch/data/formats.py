"""Fixed-shape batch assembly + prediction formatting (counterpart of
cmtcoop_tpu/data/formats.py).

Replaces mmcv's DataContainer/collate machinery (formating_coop.py) with
plain numpy dicts of static shapes: points padded to `max_points`, GT padded
to `max_gt`, fixed camera counts. Numpy only, so loader workers need not
import torch: the predictions come in as the port's `core/coder.py`
`DecodedBoxes` (or anything with `.boxes/.scores/.labels/.valid`) of
tensors on the CPU or the card, or of numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from cmtcoop_tpu_torch.utils.profiling import span


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array -> numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pad_points(points: np.ndarray, max_points: int):
    """(N, F) -> ((max_points, F), (max_points,) mask)."""
    n = min(len(points), max_points)
    out = np.zeros((max_points, points.shape[1]), np.float32)
    mask = np.zeros((max_points,), bool)
    out[:n] = points[:n]
    mask[:n] = True
    return out, mask


def pad_gt(boxes9: np.ndarray, labels: np.ndarray, max_gt: int):
    """Gravity-centered (G, 9) + (G,) -> padded (max_gt, ...) + mask."""
    g = min(len(labels), max_gt)
    out_b = np.zeros((max_gt, 9), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    mask = np.zeros((max_gt,), bool)
    out_b[:g] = boxes9[:g]
    out_l[:g] = labels[:g]
    mask[:g] = True
    return out_b, out_l, mask


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of per-sample dicts into a batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def sample_to_model_batch(
    sample: Dict, max_points: int, max_gt: int,
    prefixes: Sequence[str] = ("",), with_gt: bool = True,
) -> Dict[str, np.ndarray]:
    """Convert one pipeline-output sample into fixed-shape model arrays.

    `sample` carries, per agent prefix: `{p}points` (N, 5), optionally
    `{p}imgs` (V, H, W, 3) + `{p}lidar2img` (V, 4, 4); and shared
    `gt_boxes_3d` (bottom-centered box9) + `gt_labels_3d`.
    """
    out: Dict[str, np.ndarray] = {}
    for p in prefixes:
        if p + "points" in sample:
            pts, mask = pad_points(
                np.asarray(sample[p + "points"], np.float32), max_points)
            out[p + "points"] = pts
            out[p + "points_mask"] = mask
        if p + "imgs" in sample:
            out[p + "imgs"] = np.asarray(sample[p + "imgs"], np.float32)
            l2i = np.asarray(sample[p + "lidar2img"], np.float32)
            out[p + "lidar2img"] = l2i
            out[p + "img2lidar"] = np.linalg.inv(l2i).astype(np.float32)
    if with_gt:
        boxes = np.asarray(sample["gt_boxes_3d"], np.float32).reshape(-1, 9)
        # bottom-centered on disk -> gravity-centered for the model
        # (cmt_head.py:574-576)
        boxes = boxes.copy()
        boxes[:, 2] += boxes[:, 5] * 0.5
        gb, gl, gm = pad_gt(
            boxes, np.asarray(sample["gt_labels_3d"], np.int64), max_gt)
        out["gt_boxes"] = gb
        out["gt_labels"] = gl
        out["gt_mask"] = gm
    return out


@span("eval.boxes")
def decoded_to_eval_boxes(
    decoded, class_names: Sequence[str], timestamp,
) -> List[Dict]:
    """One sample's DecodedBoxes -> the scorer's box-dict list
    (mirrors _format_bbox, a9coop_dataset.py:293-337); the reads to the
    host in span `eval.readback`."""
    with span("eval.readback"):
        boxes = _numpy(decoded.boxes)
        scores = _numpy(decoded.scores)
        labels = _numpy(decoded.labels)
        valid = _numpy(decoded.valid)
    out = []
    for i in np.where(valid)[0]:
        b = boxes[i]
        out.append(dict(
            translation=(float(b[0]), float(b[1]),
                         float(b[2] + b[5] / 2.0)),
            size=(float(b[3]), float(b[4]), float(b[5])),
            yaw=float(b[6]),
            velocity=(float(b[7]), float(b[8])) if b.shape[0] > 7 else (0, 0),
            detection_name=class_names[int(labels[i])],
            detection_score=float(scores[i]),
            ego_dist=float(np.hypot(b[0], b[1])),
            num_pts=-1,
            timestamp=timestamp,
        ))
    return out


def gt_to_eval_boxes(boxes9: np.ndarray, labels: np.ndarray,
                     class_names: Sequence[str], timestamp,
                     num_pts: Optional[np.ndarray] = None) -> List[Dict]:
    """Bottom-centered GT box9 rows -> scorer box dicts."""
    out = []
    for i in range(len(labels)):
        b = boxes9[i]
        out.append(dict(
            translation=(float(b[0]), float(b[1]),
                         float(b[2] + b[5] / 2.0)),
            size=(float(b[3]), float(b[4]), float(b[5])),
            yaw=float(b[6]),
            velocity=(float(b[7]), float(b[8])) if b.shape[0] > 7 else (0, 0),
            detection_name=class_names[int(labels[i])],
            ego_dist=float(np.hypot(b[0], b[1])),
            num_pts=int(num_pts[i]) if num_pts is not None else -1,
            timestamp=timestamp,
        ))
    return out
