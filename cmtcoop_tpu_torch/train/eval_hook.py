"""Validation during training: the mmcv EvalHook equivalent (counterpart of
cmtcoop_tpu/train/eval_hook.py).

The reference registers a CustomDistEvalHook that runs the val split
through the model every `interval` epochs and logs the nusc-protocol metric
dict (coop config:389-399; key names a9coop_dataset.py:1000-1016:
`object/map`, `object/nds`, per-class APs). Here the same loop is a plain
function over an eval-mode model. It is a separate model from the one that
trains (`build_detector(preset, train=False, dtype=...)`, as the JAX hook
builds one): the eval modules hold packed operands keyed by each weight's
version counter (models/layers.py `_pack_key`), so the trained weights are
copied in with `load_state_dict` outside inference mode, which bumps the
counters, and the forward runs under `torch.no_grad()`.

`make_eval_hook(preset, data_root, ...)` needs the on-disk test loader and
comes with the data path; the Trainer takes any `eval_hook(state, step)`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data import formats

CODES = ("center", "height", "dim", "rot", "vel")


def make_eval_forward(model: torch.nn.Module):
    """forward(batch) -> (last-layer logits, last-layer codes): per task
    (B, Q, C) and (B, Q, 10), under `torch.no_grad()`."""

    def forward(batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            task_outs, _ = model(batch)
        logits = [t["cls_logits"][-1] for t in task_outs]
        codes = [torch.cat([t[k][-1] for k in CODES], dim=-1)
                 for t in task_outs]
        return logits, codes

    return forward


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    """A numpy batch -> tensors on `device` (non-blocking copies)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def run_eval(model: torch.nn.Module, ds, preset, batch_size: int = 1,
             max_samples: Optional[int] = None,
             work_dir: Optional[str] = None, forward=None,
             collect_preds: bool = True):
    """Run `ds` through the eval-mode `model` and score it with `ds.evaluate`
    (the nusc protocol). `ds` has `len`, `ds[i]` (a numpy sample),
    `ds.infos[i]["timestamp"]` and `ds.evaluate(preds, output_dir)`.

    The tail batch is padded by repeating the last sample, so every batch
    has one shape (the reference iterates b=1, tools/test.py:200-214).
    Returns (summary, preds by timestamp), preds None without
    `collect_preds`."""
    if forward is None:
        forward = make_eval_forward(model)
    device = next(model.parameters()).device
    preds = {}
    bs = max(1, batch_size)
    total = len(ds)
    if max_samples:
        total = min(total, max_samples)
    for start in range(0, total, bs):
        idxs = list(range(start, min(start + bs, total)))
        padded = idxs + [idxs[-1]] * (bs - len(idxs))
        batch = to_device(formats.collate([ds[i] for i in padded]), device)
        logits, codes = forward(batch)
        for b, i in enumerate(idxs):
            dec = decode_boxes([lg[b] for lg in logits],
                               [c[b] for c in codes])
            ts = ds.infos[i]["timestamp"]
            preds[ts] = formats.decoded_to_eval_boxes(
                dec, preset.class_names, ts)
    summary = ds.evaluate(preds, output_dir=work_dir)
    return summary, (preds if collect_preds else None)
