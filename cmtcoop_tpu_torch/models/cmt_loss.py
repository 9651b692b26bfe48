"""CMT training loss: Hungarian-matched focal + L1 loss per decoder layer,
plus the DN loss (counterpart of cmtcoop_tpu/models/cmt_loss.py, the
reference's cmt_head.py:556-903).

- Per (decoder layer x task): the code-weighted focal + L1 matching cost
  over the padded GT set, an exact assignment, the matched targets, a focal
  classification loss averaged over pos + 0.1 * neg and a weighted L1 loss
  averaged over pos.
- DN (cmt_head.py:759-823): labels outside the task become background, the
  box rows are filtered to the task, cls avg = num_tgt * pi / 6 * split^3.

The assignment is exact and runs on the host (core/hungarian.py): the
costs of every layer and task are computed on the device without
gradients, brought to the host in one copy with their row masks, solved,
and the matched columns go back in one copy. The losses then run on the
device under autograd.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from cmtcoop_tpu_torch.core.boxes import normalize_bbox
from cmtcoop_tpu_torch.core.hungarian import solve_lap
from cmtcoop_tpu_torch.core.losses import (focal_cost, l1_cost,
                                           sigmoid_focal_loss,
                                           weighted_l1_loss)

DEFAULT_CODE_WEIGHTS = (2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
CODES = ("center", "height", "dim", "rot", "vel")


def _safe_normalize(gt_boxes, gt_mask):
    """normalize_bbox with padded rows replaced by a finite dummy."""
    safe = torch.where(gt_mask[..., None], gt_boxes,
                       torch.ones_like(gt_boxes))
    return normalize_bbox(safe)


def _cat_code(outs, prefix=""):
    """(L, B, nq, 10) code from head outputs (center, height, dim, rot,
    vel)."""
    return torch.cat([outs[prefix + k] for k in CODES], dim=-1)


def _in_task(gt_labels, gt_mask, offset, n_cls):
    return (gt_labels >= offset) & (gt_labels < offset + n_cls) & gt_mask


def assignment_cost(pred_code, pred_logits, gt_code, gt_labels_local,
                    code_weights=DEFAULT_CODE_WEIGHTS,
                    cls_weight: float = 2.0, reg_weight: float = 0.25):
    """(G, nq) matching cost of one (sample, task): focal cost + L1 over
    the first 8 code-weighted dims."""
    cw = pred_code.new_tensor(code_weights)
    cost = focal_cost(pred_logits, gt_labels_local, weight=cls_weight) + \
        l1_cost((pred_code * cw)[:, :8], (gt_code * cw)[:, :8],
                weight=reg_weight)
    return cost.T


def match(task_outs, gt_boxes, gt_labels, gt_mask,
          tasks: Sequence[Sequence[str]],
          code_weights=DEFAULT_CODE_WEIGHTS) -> torch.Tensor:
    """Matched query per GT slot for every (layer, task, sample):
    (L, T, B, G) int64 on the device, nq where the slot is not matched
    (invalid or outside the task). One device-to-host copy of the stacked
    costs and masks, one copy back."""
    num_layers = task_outs[0]["center"].shape[0]
    b, g = gt_labels.shape
    nq = task_outs[0]["center"].shape[2]
    costs, masks = [], []
    with torch.no_grad():
        offset = 0
        for t, names in enumerate(tasks):
            n_cls = len(names)
            in_task = _in_task(gt_labels, gt_mask, offset, n_cls)
            local = (gt_labels - offset).clamp(0, n_cls - 1)
            gt_code = _safe_normalize(gt_boxes.float(), in_task)
            code = _cat_code(task_outs[t]).float()
            logits = task_outs[t]["cls_logits"].float()
            for layer in range(num_layers):
                costs.append(torch.stack([
                    assignment_cost(code[layer, i], logits[layer, i],
                                    gt_code[i], local[i], code_weights)
                    for i in range(b)]))
            masks.append(in_task)
            offset += n_cls
        packed = torch.cat([torch.stack(costs).reshape(-1),
                            torch.stack(masks).reshape(-1).float()])
    host = packed.cpu().numpy()
    n_cost = len(tasks) * num_layers * b * g * nq
    cost = host[:n_cost].reshape(len(tasks), num_layers, b, g, nq)
    valid = host[n_cost:].reshape(len(tasks), b, g) > 0.5
    cols = np.full((num_layers, len(tasks), b, g), nq, np.int64)
    for t in range(len(tasks)):
        for layer in range(num_layers):
            for i in range(b):
                c4r = solve_lap(cost[t, layer, i], valid[t, i])
                cols[layer, t, i] = np.where(valid[t, i], c4r, nq)
    return torch.from_numpy(cols).to(gt_labels.device)


def task_targets(col4row, pred_code, gt_boxes, gt_labels, gt_mask,
                 offset: int, n_cls: int):
    """Targets of one (layer, task) from its matched columns col4row (B, G)
    (nq = unmatched): labels (B, nq) in [0, n_cls], label_weights,
    bbox_targets (B, nq, 10), bbox_weights, num_pos."""
    b, nq, _ = pred_code.shape
    in_task = _in_task(gt_labels, gt_mask, offset, n_cls)
    local = (gt_labels - offset).clamp(0, n_cls - 1)
    gt_code = _safe_normalize(gt_boxes.float(), in_task).to(pred_code.dtype)
    rows = torch.arange(b, device=pred_code.device)[:, None].expand_as(
        col4row)
    labels = torch.full((b, nq + 1), n_cls, dtype=torch.long,
                        device=pred_code.device)
    labels[rows, col4row] = local.long()
    bbox_targets = pred_code.new_zeros(b, nq + 1, 10)
    bbox_targets[rows, col4row] = gt_code
    bbox_weights = pred_code.new_zeros(b, nq + 1, 10)
    bbox_weights[rows, col4row] = 1.0
    label_weights = pred_code.new_ones(b, nq)
    return (labels[:, :nq], label_weights, bbox_targets[:, :nq],
            bbox_weights[:, :nq], in_task.sum())


def cmt_loss(task_outs, dn_info, gt_boxes, gt_labels, gt_mask,
             tasks: Tuple[Tuple[str, ...], ...],
             code_weights=DEFAULT_CODE_WEIGHTS, cls_loss_weight: float = 2.0,
             bbox_loss_weight: float = 0.25, dn_weight: float = 1.0,
             split: float = 0.75) -> Dict[str, torch.Tensor]:
    """The loss dict keyed like the reference's log (`d{i}.loss_cls/bbox`,
    `loss_cls/bbox`, the `dn_` counterparts, `loss` their sum)."""
    gt_mask = gt_mask.bool()
    losses: Dict[str, torch.Tensor] = {}
    num_layers = task_outs[0]["center"].shape[0]
    cw = torch.tensor(code_weights, device=gt_boxes.device)
    cols = match(task_outs, gt_boxes, gt_labels, gt_mask, tasks,
                 code_weights)
    for layer in range(num_layers):
        l_cls = l_bbox = 0.0
        offset = 0
        for t, names in enumerate(tasks):
            n_cls = len(names)
            outs = task_outs[t]
            pred_code = _cat_code(outs)[layer].float()
            pred_logits = outs["cls_logits"][layer].float()
            labels, label_w, bbox_t, bbox_w, num_pos = task_targets(
                cols[layer, t], pred_code, gt_boxes, gt_labels, gt_mask,
                offset, n_cls)
            num_pos = num_pos.float()
            cls_avg = num_pos + 0.1 * (labels.numel() - num_pos)
            l_cls = l_cls + sigmoid_focal_loss(
                pred_logits.reshape(-1, n_cls), labels.reshape(-1),
                label_w.reshape(-1), n_cls, cls_avg,
                loss_weight=cls_loss_weight)
            l_bbox = l_bbox + weighted_l1_loss(
                pred_code, bbox_t, bbox_w * cw, num_pos,
                loss_weight=bbox_loss_weight)
            offset += n_cls
        tag = "" if layer == num_layers - 1 else f"d{layer}."
        losses[f"{tag}loss_cls"] = torch.nan_to_num(l_cls)
        losses[f"{tag}loss_bbox"] = torch.nan_to_num(l_bbox)
    if dn_info is not None:
        _dn_losses(losses, task_outs, dn_info, tasks, cw, cls_loss_weight,
                   bbox_loss_weight, dn_weight, split)
    losses["loss"] = sum(v for k, v in losses.items() if k != "loss")
    return losses


def _dn_losses(losses, task_outs, dn_info, tasks, cw, cls_loss_weight,
               bbox_loss_weight, dn_weight, split):
    num_layers = task_outs[0]["center"].shape[0]
    b = dn_info.valid.shape[0]
    valid = dn_info.valid.reshape(b, -1)
    num_tgt = valid.sum().float()
    num_tgt_mean = num_tgt.clamp(min=1.0)
    gt_code = _safe_normalize(dn_info.known_boxes.reshape(b, -1, 9).float(),
                              valid)
    kl = dn_info.known_labels.reshape(b, -1)
    raw = dn_info.known_labels_raw.reshape(b, -1)
    cls_avg = (num_tgt * math.pi / 6.0 * split ** 3).clamp(min=1.0)
    for layer in range(num_layers):
        l_cls = l_bbox = 0.0
        offset = 0
        for t, names in enumerate(tasks):
            n_cls = len(names)
            outs = task_outs[t]
            pred_code = _cat_code(outs, "dn_")[layer].float()
            pred_logits = outs["dn_cls_logits"][layer].float()
            in_task_noised = (kl >= offset) & (kl < offset + n_cls)
            labels_t = torch.where(in_task_noised, kl - offset, n_cls)
            in_task_raw = (raw >= offset) & (raw < offset + n_cls) & valid
            l_cls = l_cls + sigmoid_focal_loss(
                pred_logits.reshape(-1, n_cls), labels_t.reshape(-1),
                valid.reshape(-1).float(), n_cls, cls_avg,
                loss_weight=cls_loss_weight)
            l_bbox = l_bbox + weighted_l1_loss(
                pred_code, gt_code, in_task_raw[..., None] * cw,
                num_tgt_mean, loss_weight=bbox_loss_weight)
            offset += n_cls
        tag = "" if layer == num_layers - 1 else f"d{layer}."
        losses[f"{tag}dn_loss_cls"] = torch.nan_to_num(dn_weight * l_cls)
        losses[f"{tag}dn_loss_bbox"] = torch.nan_to_num(dn_weight * l_bbox)
