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


def _np_dtype(t):
    """The numpy dtype of tensor `t`'s dtype."""
    import torch
    return torch.empty((), dtype=t.dtype).numpy().dtype


def pack_decoded(decoded):
    """A DecodedBoxes of tensors -> one (K, C + 3) tensor on their device:
    the C box columns, the score, the label and valid (0/1), in the widest
    of the boxes', the scores' and float32's dtypes (labels are exact below
    2**24), so that it comes to the host in one copy."""
    import torch  # reached with tensors only: the loader needs no torch
    dt = torch.promote_types(torch.promote_types(decoded.boxes.dtype,
                                                 decoded.scores.dtype),
                             torch.float32)
    return torch.cat([decoded.boxes.detach().to(dt),
                      decoded.scores.detach()[:, None].to(dt),
                      decoded.labels.detach()[:, None].to(dt),
                      decoded.valid.detach()[:, None].to(dt)], dim=1)


def _host_arrays(decoded):
    """(boxes, scores, labels, valid) of `decoded` as numpy arrays, each in
    its own dtype. Tensors come to the host in one copy of
    `pack_decoded`'s, in span `eval.readback`: on the card, the one wait
    of the frame."""
    if not hasattr(decoded.boxes, "detach"):
        return tuple(np.asarray(x) for x in (decoded.boxes, decoded.scores,
                                             decoded.labels, decoded.valid))
    packed = pack_decoded(decoded)
    with span("eval.readback"):
        host = packed.cpu().numpy()
    c = decoded.boxes.shape[-1]
    return (host[:, :c].astype(_np_dtype(decoded.boxes)),
            host[:, c].astype(_np_dtype(decoded.scores)),
            host[:, c + 1].astype(_np_dtype(decoded.labels)),
            host[:, c + 2] != 0)


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
    (mirrors _format_bbox, a9coop_dataset.py:293-337); tensors are read
    to the host in one copy, in span `eval.readback`."""
    boxes, scores, labels, valid = _host_arrays(decoded)
    idx = np.flatnonzero(valid)
    b = boxes[idx]
    cols = b.T.tolist()
    z = (b[:, 2] + b[:, 5] / 2.0).tolist()
    dist = np.hypot(b[:, 0], b[:, 1]).tolist()
    vel = (list(zip(cols[7], cols[8])) if b.shape[1] > 7
           else [(0, 0)] * len(idx))
    names = [class_names[int(v)] for v in labels[idx].tolist()]
    score = scores[idx].tolist()
    return [dict(
        translation=(cols[0][j], cols[1][j], z[j]),
        size=(cols[3][j], cols[4][j], cols[5][j]),
        yaw=cols[6][j],
        velocity=vel[j],
        detection_name=names[j],
        detection_score=score[j],
        ego_dist=dist[j],
        num_pts=-1,
        timestamp=timestamp,
    ) for j in range(len(idx))]


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
