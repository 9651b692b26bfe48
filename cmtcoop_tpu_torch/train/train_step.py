"""One training step (counterpart of `make_train_step` in
cmtcoop_tpu/parallel/train_step.py): forward with DN, grid mask and
dropout, the Hungarian-matched `cmt_loss`, backward, the clipped AdamW
update, and the metrics dict (every loss term and the pre-clip
`grad_norm`).

The step's randomness comes from three CPU generators (DN noise, dropout
seeds, grid-mask draws) seeded from (seed, step), as the JAX step folds the
step into its key: a step is reproducible from its number alone.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from cmtcoop_tpu_torch.models.cmt_loss import cmt_loss
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.utils.profiling import span


class StepGenerators(NamedTuple):
    dn: torch.Generator
    dropout: torch.Generator
    gridmask: torch.Generator


def step_generators(seed: int, step: int) -> StepGenerators:
    """The step's three CPU generators, seeded from (seed, step, stream)."""
    states = np.random.SeedSequence([seed, step]).generate_state(3)
    return StepGenerators(*(torch.Generator().manual_seed(int(s))
                            for s in states))


def make_train_step(model: torch.nn.Module, optimizer: AdamW, tasks,
                    base_seed: int = 0):
    """Returns step(batch) -> metrics (device scalars). The model must be in
    train mode. The stages run in the spans `forward`, `loss + Hungarian`,
    `backward` and `optimizer` (utils/profiling.py)."""

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        rngs = step_generators(base_seed, optimizer.count)
        for p in optimizer.params:
            p.grad = None
        with span("forward"):
            task_outs, dn_info = model(batch, rngs)
        with span("loss + Hungarian"):
            losses = cmt_loss(task_outs, dn_info, batch["gt_boxes"],
                              batch["gt_labels"], batch["gt_mask"], tasks)
        with span("backward"):
            losses["loss"].backward()
        with span("optimizer"):
            grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return step
