"""The comparison that decides `correct` for a served detector.

Each frame's answer is its list of boxes on the host, as the program's
offline eval hands them to the scorer: per box a translation (the box
centre), size, yaw, velocity, class name and score. The reference gives,
for the same frame, every query's box and every (query, class) score.

- `box_gap`: for each served box, its distance to the nearest reference
  query's box: the largest difference over the centre (m), the
  logarithms of the size, the yaw (rad, wrapped) and the velocity (m/s),
  each in its own unit; the widest over the served boxes. A box that is
  altered lies far from every query; rounding moves it a little from its
  own. `box_rms`: the root mean square of the same distances over the
  frame's boxes, which a lower precision moves as a whole and a rare
  near-tie (the agents' max fusion, a flipped rank) does not.
- `score_gap`, `score_rms`: the served scores, highest first, against the
  reference's top-k, highest first, rank by rank: the widest difference,
  and the root mean square of the differences. They read which boxes
  were served and what they score: a k-th largest score moves by no more
  than the scores do, so a right answer's ranks agree to rounding
  whatever the order of ties.
- `query_score_gap`, `query_score_rms`: each served box against the
  reference query it matched (the nearest, as `box_gap` finds it): its
  score against that query's reference score for the served class, the
  widest difference and the root mean square over the frame's boxes. A
  score raised, a class relabelled or a query's logits swapped for
  another's reads here, box by box, whatever the ranks do.

A frame's numbers are taken over its boxes, the run's over its frames
(the widest). A cell's limits file names the numbers it compares.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from bench_torch.reference import RefOutput

NAMES = ("box_gap", "box_rms", "score_gap", "score_rms", "query_score_gap",
         "query_score_rms")


def served_arrays(boxes: List[dict], class_names: Sequence[str]):
    """(n, 9) boxes, (n,) class ids, (n,) scores of one served frame."""
    idx = {c: i for i, c in enumerate(class_names)}
    geo = np.array([[*b["translation"], *b["size"], b["yaw"],
                     *b["velocity"]] for b in boxes], np.float64)
    labels = np.array([idx[b["detection_name"]] for b in boxes], np.int64)
    scores = np.array([b["detection_score"] for b in boxes], np.float64)
    return geo.reshape(-1, 9), labels, scores


def finite(boxes: List[dict]) -> bool:
    """Every number of a served frame's boxes is finite."""
    return all(np.isfinite([*b["translation"], *b["size"], b["yaw"],
                            *b["velocity"], b["detection_score"]]).all()
               for b in boxes)


def _code(boxes: np.ndarray) -> np.ndarray:
    """(n, 9) boxes -> the compared numbers: centre, log size, yaw,
    velocity."""
    out = boxes.copy()
    out[:, 3:6] = np.log(np.maximum(boxes[:, 3:6], 1e-30))
    return out


def frame_gaps(boxes: List[dict], ref: RefOutput,
               class_names: Sequence[str]) -> Dict[str, float]:
    """The numbers of one served frame against its reference answer (inf
    where the answer holds a number that is not finite, or where it holds
    another count of boxes than the reference's top-k)."""
    geo, labels, scores = served_arrays(boxes, class_names)
    if not (np.isfinite(geo).all() and np.isfinite(scores).all()):
        return dict.fromkeys(NAMES, float("inf"))
    d = np.abs(_code(geo)[:, None, :] - _code(ref.boxes)[None])
    d[..., 6] = np.abs((d[..., 6] + np.pi) % (2 * np.pi) - np.pi)
    dist = d.max(-1)
    near = dist.min(1) if len(dist) else np.zeros(0)
    own = np.abs(scores - ref.scores[dist.argmin(1), labels]) \
        if len(dist) else np.zeros(0)
    out = dict(box_gap=float(near.max()) if len(near) else 0.0,
               box_rms=float(np.sqrt(np.mean(near ** 2)))
               if len(near) else 0.0,
               query_score_gap=float(own.max()) if len(own) else 0.0,
               query_score_rms=float(np.sqrt(np.mean(own ** 2)))
               if len(own) else 0.0)
    if len(scores) != len(ref.top_scores):
        out.update(score_gap=float("inf"), score_rms=float("inf"))
    else:
        diff = np.abs(np.sort(scores)[::-1] - ref.top_scores)
        out.update(score_gap=float(diff.max()),
                   score_rms=float(np.sqrt(np.mean(diff ** 2))))
    return out


def verdict(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that the cell's limits name is within its limit."""
    return all(gaps[k] <= v for k, v in limits.items())


def checks_line(gaps: Dict[str, float], limits: Dict[str, float],
                compared: int) -> Dict[str, dict]:
    """Each number compared beside its limit, for the result line."""
    out = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    out["frames_compared"] = {"value": compared, "limit": 1}
    return out


def as_served(ref: RefOutput, class_names: Sequence[str]) -> List[dict]:
    """A reference answer served as the program serves its own: the top-k
    (query, class) pairs by score, each as a scorer's box dict. The control
    takes the program's place through this."""
    n_cls = ref.scores.shape[1]
    flat = ref.scores.reshape(-1)
    top = np.argsort(-flat, kind="stable")[:len(ref.top_scores)]
    out = []
    for i in top:
        q, c = divmod(int(i), n_cls)
        b = ref.boxes[q]
        out.append(dict(translation=(b[0], b[1], b[2]), size=tuple(b[3:6]),
                        yaw=b[6], velocity=(b[7], b[8]),
                        detection_name=class_names[c],
                        detection_score=float(flat[i])))
    return out
