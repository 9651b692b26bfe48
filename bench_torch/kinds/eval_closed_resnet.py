"""Traffic kind `eval_closed_resnet`: `eval_closed_single` for a
single-agent detector whose camera branch is a ResNet (the program's
`CmtDetector` with `img_spec` "r50"). The loop, the set-up, the window, the
traced frames and the comparison are that kind's `run`, its `eval_server`
and `instrument` included; only its plain reference and its operation
count differ, so `run` here calls that kind's `run` with its two names
bound, for the call, to `reference_resnet.ResNetReference` and
`flops_resnet` (whose `frame_flops` counts the ResNet branch). Folding
the two into parameters of that kind is left to ROADMAP queue 4 item 1.
"""
from __future__ import annotations

from unittest import mock

from bench_torch import flops_resnet
from bench_torch.kinds import eval_closed_single
from bench_torch.reference_resnet import ResNetReference


def run(cell, args, device, t_start: float) -> dict:
    with mock.patch.multiple(eval_closed_single,
                             SingleReference=ResNetReference,
                             flops=flops_resnet):
        return eval_closed_single.run(cell, args, device, t_start)
