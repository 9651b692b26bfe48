"""The analytic count of a frame's operations (flops.py) equals PyTorch's
FlopCounterMode over the plain reference's forward, at the small
detectors' sizes."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import flops, generator, program
from bench_torch.reference import Reference
from bench_torch.tests.conftest import DATA
from bench_torch.weights import make_weights


@pytest.mark.parametrize("name", ["tiny_fusion_coop", "tiny_lidar_coop"])
@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_analytic_count_equals_the_counter(name, seed):
    cfg = json.loads((DATA / f"{name}.json").read_text())
    traffic = json.loads((DATA / "tiny_eval.json").read_text())
    shapes = program.state_shapes(
        program.build_eval_model(cfg, torch.device("meta")))
    ref = Reference(cfg, make_weights(shapes, seed, torch.device("cpu")))
    host = generator.frame_pool(traffic, cfg, seed)[0]
    counts = {a: ref.active_counts(
        torch.from_numpy(host[f"{a}_points"][0]),
        torch.from_numpy(host[f"{a}_points_mask"][0]))
        for a in cfg["agents"]}
    with FlopCounterMode(display=False) as counter:
        ref.frame(host)
    assert flops.frame_flops(cfg, counts) == counter.get_total_flops()
