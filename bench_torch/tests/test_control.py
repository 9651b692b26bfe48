"""The control at each cell's own size, on the card: the plain reference
in float8 operands put in the program's place is refused by the cell's
limits on three seeds. Needs a CUDA device; skips without one."""
from __future__ import annotations

import json

import pytest
import torch

from bench_torch import control
from bench_torch.tests.conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on the card")
    readings = control.main(["--workload", cell, "--seeds", "610001",
                             "610002", "610003"])
    assert [r["correct"] for r in readings] == [False] * 3
