"""AdamW with per-module LR groups, cyclic LR and beta1, and a global-norm
clip at 35 (counterpart of cmtcoop_tpu/train/optim.py, whose optax chain is
`clip_by_global_norm(35)` then `multi_transform` of one
`inject_hyperparams(adamw)` per group).

The reference recipe (coop config:362-388): AdamW lr 1e-4, weight decay
0.01; `img_backbone` lr x0.01 and decay x5, `img_neck` lr x0.1; mmcv's
cyclic LR (target ratio (2, 1e-4), up 40% of the steps) and cyclic beta1
(0.85 / 0.95 of 0.95, i.e. 0.8947 of the base) with cosine annealing,
per step. optax's semantics are kept, not torch.optim's:

- the clip scales by max_norm / norm with no epsilon (torch's
  `clip_grad_norm_` adds 1e-6);
- every parameter is decayed (no mask), decoupled: update = adam + wd * p,
  then p -= lr * update;
- the bias corrections use the current beta1; the schedules are read at
  the count before the step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

# The reference recipe's constants (coop config:362-388 and optax's adamw).
BASE_LR = 1e-4
WEIGHT_DECAY = 0.01
CLIP_NORM = 35.0
LR_TARGET_RATIO = (2.0, 1e-4)
MOMENTUM_TARGET_RATIO = (0.8947368421052632, 1.0)  # 0.85 / 0.95
STEP_RATIO_UP = 0.4
BASE_BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
PARAM_GROUPS: Dict[str, Tuple[float, float]] = {
    # substring of the parameter name -> (lr_mult, decay_mult)
    "img_backbone": (0.01, 5.0),
    "img_neck": (0.1, 1.0),
}


def annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def cyclic_schedule(base: float, total_steps: int,
                    target_ratio: Tuple[float, float]) -> Callable[[int],
                                                                   float]:
    """mmcv's CyclicLrUpdaterHook (cyclic_times 1, cosine, up for
    STEP_RATIO_UP of the steps), per step; also the momentum schedule with
    the momentum's target ratio."""
    up_steps = int(total_steps * STEP_RATIO_UP)

    def sched(step: int) -> float:
        step = min(step, total_steps - 1)
        if step < up_steps:
            return annealing_cos(base, base * target_ratio[0],
                                 step / max(up_steps, 1))
        return annealing_cos(base * target_ratio[0], base * target_ratio[1],
                             (step - up_steps) / max(total_steps - up_steps,
                                                     1))

    return sched


def group_label(name: str) -> str:
    """The first PARAM_GROUPS key that is a substring of `name`, else
    "default"."""
    return next((key for key in PARAM_GROUPS if key in name), "default")


class AdamW:
    """The optimizer over a model's named parameters. `step()` reads each
    parameter's `.grad` (None counts as zero, as every leaf of a JAX
    gradient tree exists), clips, updates in place and returns the global
    gradient norm before the clip (a device scalar)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 total_steps: int):
        self.names, self.params = [], []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p)
        self.beta1 = cyclic_schedule(BASE_BETA1, total_steps,
                                     MOMENTUM_TARGET_RATIO)
        # label -> (indices, lr schedule, weight decay)
        self.groups = {}
        for label, (lr_mult, decay_mult) in [("default", (1.0, 1.0))] + \
                list(PARAM_GROUPS.items()):
            idx = [i for i, n in enumerate(self.names)
                   if group_label(n) == label]
            self.groups[label] = (idx, cyclic_schedule(
                BASE_LR * lr_mult, total_steps, LR_TARGET_RATIO),
                WEIGHT_DECAY * decay_mult)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        factor = torch.where(norm < CLIP_NORM, torch.ones_like(norm),
                             CLIP_NORM / norm)
        c = self.count
        b1, b2 = self.beta1(c), BETA2
        bc1, bc2 = 1.0 - b1 ** (c + 1), 1.0 - b2 ** (c + 1)
        for idx, lr_sched, wd in self.groups.values():
            if not idx:
                continue
            ps = [self.params[i] for i in idx]
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            g = torch._foreach_mul([grads[i] for i in idx], factor)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(upd, ps, alpha=wd)
            torch._foreach_add_(ps, upd, alpha=-lr_sched(c))
        self.count += 1
        return norm
