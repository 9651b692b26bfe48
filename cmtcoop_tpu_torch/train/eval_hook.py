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

`make_eval_hook(preset, data_root, ...)` builds that model and the on-disk
test dataset once and returns the Trainer's `eval_hook(state, step)`;
`run_eval` is also the body of the test CLI (tools/test.py), so the
mid-training eval and the offline eval are the same code path.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from cmtcoop_tpu_torch.configs.presets import post_center_range
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data import formats
from cmtcoop_tpu_torch.data.loader import build_test_loader
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.utils import staging
from cmtcoop_tpu_torch.utils.profiling import count, span

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


@span("eval.to_device")
def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    """A numpy batch -> tensors on `device`. To a CUDA device each host
    array goes through the pinned ring of `utils/staging.py`: when this
    returns, every copy is enqueued on the current stream, each tensor is
    ready in that stream's order, and the host arrays may be overwritten.
    Other devices take `Tensor.to` (non-blocking). Counts the bytes copied
    from the host to another device (`h2d.bytes`), and those of them that
    the DMA reads from pageable memory (`h2d.pageable_bytes`, 0 on the
    staged path)."""
    device = torch.device(device)
    out, nbytes, pageable = {}, 0, 0
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.device.type == "cpu" and device.type != "cpu":
            n = t.numel() * t.element_size()
            nbytes += n
            if device.type == "cuda":
                out[k] = staging.upload(t, device)
                continue
            if not t.is_pinned():
                pageable += n
        out[k] = t.to(device, non_blocking=True)
    count("h2d.bytes", nbytes)
    count("h2d.pageable_bytes", pageable)
    return out


def run_eval(model: torch.nn.Module, ds, preset, batch_size: int = 1,
             max_samples: Optional[int] = None,
             work_dir: Optional[str] = None, forward=None,
             collect_preds: bool = True):
    """Run `ds` through the eval-mode `model` and score it with `ds.evaluate`
    (the nusc protocol). `ds` has `len`, `ds[i]` (a numpy sample),
    `ds.infos[i]["timestamp"]` and `ds.evaluate(preds, output_dir)`.

    The tail batch is padded by repeating the last sample, so every batch
    has one shape (the reference iterates b=1, tools/test.py:200-214).
    The decode keeps boxes inside the preset's post-centre range
    (`presets.post_center_range`). Returns (summary, preds by timestamp),
    preds None without `collect_preds`."""
    if forward is None:
        forward = make_eval_forward(model)
    device = next(model.parameters()).device
    preds = {}
    bs = max(1, batch_size)
    total = len(ds)
    centre_range = post_center_range(preset)
    if max_samples:
        total = min(total, max_samples)
    for start in range(0, total, bs):
        idxs = list(range(start, min(start + bs, total)))
        padded = idxs + [idxs[-1]] * (bs - len(idxs))
        batch = to_device(formats.collate([ds[i] for i in padded]), device)
        logits, codes = forward(batch)
        for b, i in enumerate(idxs):
            dec = decode_boxes([lg[b] for lg in logits],
                               [c[b] for c in codes],
                               post_center_range=centre_range)
            ts = ds.infos[i]["timestamp"]
            preds[ts] = formats.decoded_to_eval_boxes(
                dec, preset.class_names, ts)
    summary = ds.evaluate(preds, output_dir=work_dir)
    return summary, (preds if collect_preds else None)


def make_eval_hook(preset, data_root: str, split: str = "val",
                   dtype: torch.dtype = torch.float32, batch_size: int = 1,
                   max_samples: Optional[int] = None, device="cuda"
                   ) -> Callable[[Dict[str, Any], int], Dict[str, float]]:
    """A Trainer `eval_hook(state, step) -> metric dict` over the `split`
    of the on-disk data under `data_root`.

    One eval-mode detector (computing in `dtype`, on `device`) and one test
    dataset are built here, once; each call loads the trained state_dict
    (`state["model"]`) into the detector and runs `run_eval`. Returns
    `object/map`, `object/nds` and the scorer's numeric details (per-class
    APs and the TP errors)."""
    model = build_detector(preset, train=False, dtype=dtype, device=device)
    ds, _ = build_test_loader(preset, data_root, split=split)
    forward = make_eval_forward(model)

    def hook(state: Dict[str, Any], step: int) -> Dict[str, float]:
        model.load_state_dict(state["model"])
        summary, _ = run_eval(model, ds, preset, batch_size=batch_size,
                              max_samples=max_samples, forward=forward,
                              collect_preds=False)
        out = {"object/map": float(summary["mean_ap"]),
               "object/nds": float(summary["nd_score"])}
        out.update({k: float(v) for k, v in summary["detail"].items()
                    if isinstance(v, (int, float))})
        return out

    return hook
