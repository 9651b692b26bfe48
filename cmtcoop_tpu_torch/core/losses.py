"""Detection losses and matching costs with mmdet's semantics (counterpart
of cmtcoop_tpu/core/losses.py): sigmoid focal loss and weighted L1 reduced
as sum / avg_factor, and the pairwise focal and L1 costs of the Hungarian
assigner."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_weights: torch.Tensor, num_classes: int,
                       avg_factor, gamma: float = 2.0, alpha: float = 0.25,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """mmdet's sigmoid focal loss: logits (N, C), labels (N,) in [0, C]
    with C the background (an all-zero one-hot row), label_weights (N,)."""
    target = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes].to(
        logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) * \
        pt.pow(gamma)
    bce = sigmoid_bce(logits, target)
    loss = bce * focal_weight * label_weights[..., None]
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss_weight * loss.sum() / avg.clamp(min=1.0)


def sigmoid_bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross entropy with logits (optax's)."""
    return torch.clamp(logits, min=0.0) - logits * target + torch.log1p(
        torch.exp(-logits.abs()))


def weighted_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor, avg_factor,
                     loss_weight: float = 1.0) -> torch.Tensor:
    """mmdet's L1Loss with per-element weights, sum / avg_factor."""
    loss = (pred - target).abs() * weights
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss_weight * loss.sum() / avg.clamp(min=1.0)


def focal_cost(logits: torch.Tensor, gt_labels: torch.Tensor,
               weight: float = 2.0, alpha: float = 0.25, gamma: float = 2.0,
               eps: float = 1e-12) -> torch.Tensor:
    """mmdet's FocalLossCost: (num_query, num_gt) classification cost."""
    p = torch.sigmoid(logits.float())
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p.pow(gamma)
    pos = -torch.log(p + eps) * alpha * (1.0 - p).pow(gamma)
    idx = gt_labels.long()
    return (pos[:, idx] - neg[:, idx]) * weight


def l1_cost(pred: torch.Tensor, gt: torch.Tensor,
            weight: float = 0.25) -> torch.Tensor:
    """mmdet's BBox3DL1Cost: pairwise L1 distance (num_query, num_gt)."""
    return (pred[:, None, :] - gt[None, :, :]).abs().sum(-1) * weight
