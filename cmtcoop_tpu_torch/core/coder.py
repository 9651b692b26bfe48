"""NMS-free multi-task box decoding (counterpart of cmtcoop_tpu/core/coder.py).

Static flat top-`max_num` over (query x class) of the sigmoid scores, a
validity mask from the post-center range, and the z shift to the box bottom.
The decode's constants are cached per values, dtype and device
(`utils/constants.py`), so it neither copies from the host nor waits for the
card: its kernels queue behind the forward's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from cmtcoop_tpu_torch.core.boxes import (denormalize_bbox,
                                          gravity_to_bottom_center)
from cmtcoop_tpu_torch.utils.constants import constant
from cmtcoop_tpu_torch.utils.profiling import span


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor   # (max_num, 9) bottom-centered box9
    scores: torch.Tensor  # (max_num,)
    labels: torch.Tensor  # (max_num,) global class ids, int32
    valid: torch.Tensor   # (max_num,) bool


@span("eval.decode")
def decode_boxes(
    task_logits: Sequence[torch.Tensor],
    task_codes: Sequence[torch.Tensor],
    max_num: int = 300,
    post_center_range: Sequence[float] = (-80.0, -80.0, -10.0,
                                          80.0, 80.0, 10.0),
    score_threshold: Optional[float] = None,
) -> DecodedBoxes:
    """Decode one sample's final-layer predictions.

    task_logits: per task (num_query, C_t); task_codes: per task
    (num_query, 10) in the order (center2, height1, dim3, rot2, vel2)."""
    num_query = task_logits[0].shape[0]
    device = task_logits[0].device
    all_logits = torch.cat(list(task_logits), dim=-1)
    all_codes = torch.cat(list(task_codes), dim=0).float()
    class_task = []
    for t, lg in enumerate(task_logits):
        class_task.extend([t] * lg.shape[-1])
    class_task_arr = constant(class_task, torch.long, device)
    total_classes = all_logits.shape[-1]

    scores_flat = torch.sigmoid(all_logits.float()).reshape(-1)
    top_scores, top_idx = torch.topk(
        scores_flat, min(max_num, scores_flat.shape[0]))
    labels = top_idx % total_classes
    query_idx = top_idx // total_classes
    codes = all_codes[class_task_arr[labels] * num_query + query_idx]

    boxes = denormalize_bbox(codes)
    rng = constant(post_center_range, boxes.dtype, device)
    valid = (boxes[..., :3] >= rng[:3]).all(-1) & \
        (boxes[..., :3] <= rng[3:]).all(-1)
    if score_threshold is not None:
        valid &= top_scores > score_threshold
    return DecodedBoxes(gravity_to_bottom_center(boxes), top_scores,
                        labels.to(torch.int32), valid)
