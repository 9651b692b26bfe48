"""Fixtures of the benchmark's CPU self-tests: a checkout in a temp
directory whose BENCHMARK.json names the small cells of `data/` (the
port's small cooperative detectors), with this harness copied in."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
DATA = HERE / "data"
# the small cells, each with the repository's cell whose numbers it
# compares: a small cell's limits file names the numbers that cell's
# limits file names, with the values of data/tiny_limits.json, which sit
# above the bf16 program's readings at this size on the CPU (box_gap
# 0.034-0.060, box_rms 0.020-0.025, score_rms 0.0004-0.0012,
# query_score_gap 0.0009-0.0020, query_score_rms 0.0005-0.0013 over 4-8
# seeds) and below the fp8 control's (box_rms 0.16-0.27, query_score_rms
# 0.0039-0.0094 on 2 seeds)
SMALL_CELLS = {"tiny_fusion.eval": ("tiny_fusion_coop",
                                    "fusion_coop.eval_b1"),
               "tiny_lidar.eval": ("tiny_lidar_coop", "lidar_coop.eval_b1")}


def make_checkout(root: Path, dtype: str = "bfloat16") -> Path:
    """`root` as a checkout: BENCHMARK.json (the repository's metrics, the
    small cells) and a copy of the harness with the small cells' files."""
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    d = root / BENCH.name
    bench["configs"], bench["workloads"] = [], []
    tiny = json.loads((DATA / "tiny_limits.json").read_text())
    for cell, (conf, like) in SMALL_CELLS.items():
        cfg = json.loads((DATA / f"{conf}.json").read_text())
        cfg["dtype"] = dtype
        (d / "configs" / f"{conf}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": conf, "source": cfg["source"],
                                 "file": f"{BENCH.name}/configs/{conf}.json",
                                 "reduced": [],
                                 "why": "the small detector on the CPU"})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": "tiny_eval", "chips": 1,
                                   "why": "the small detector on the CPU"})
        names = json.loads((BENCH / "limits" / f"{like}.json").read_text())
        (d / "limits" / f"{cell}.json").write_text(
            json.dumps({k: tiny[k] for k in names}))
    shutil.copy(DATA / "tiny_eval.json", d / "traffic" / "tiny_eval.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture()
def checkout(tmp_path):
    return make_checkout(tmp_path)


@pytest.fixture(autouse=True)
def few_threads():
    """One intra-op thread, so the tests leave the machine's cores to
    whatever else runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
