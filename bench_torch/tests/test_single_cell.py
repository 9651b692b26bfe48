"""A single-agent, multi-task cell end to end on the CPU through the
`eval_closed_single` kind: the port's small fusion detector as one agent
with the six nuScenes task groups and six views (data/tiny_fusion_nusc.json,
traffic data/tiny_eval_single.json), added to a checkout as new files and
entries, no file of the harness edited. Its run reads correct; a box
moved where the program decodes reads not correct. The cell compares the
numbers that `fusion_nusc.eval_b1`'s limits file names, at the small
cells' limits (conftest.py)."""
from __future__ import annotations

import hashlib
import json

import pytest

from bench_torch import run as bench_run
from bench_torch.tests.conftest import BENCH, DATA

CELL = "tiny_nusc.eval"
LIKE = "fusion_nusc.eval_b1"


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench_torch").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture()
def single(checkout):
    """The checkout with the small single-agent cell added."""
    before = _digests(checkout)
    d = checkout / "bench_torch"
    cfg = json.loads((DATA / "tiny_fusion_nusc.json").read_text())
    cfg["dtype"] = "bfloat16"
    (d / "configs" / "tiny_fusion_nusc.json").write_text(json.dumps(cfg))
    (d / "traffic" / "tiny_eval_single.json").write_text(
        (DATA / "tiny_eval_single.json").read_text())
    tiny = json.loads((DATA / "tiny_limits.json").read_text())
    names = json.loads((BENCH / "limits" / f"{LIKE}.json").read_text())
    (d / "limits" / f"{CELL}.json").write_text(
        json.dumps({k: tiny[k] for k in names}))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_fusion_nusc",
                             "source": cfg["source"],
                             "file": "bench_torch/configs/"
                                     "tiny_fusion_nusc.json",
                             "reduced": [],
                             "why": "the small single-agent detector"})
    bench["workloads"].append({"name": CELL, "config": "tiny_fusion_nusc",
                               "traffic": "tiny_eval_single", "chips": 1,
                               "why": "the small single-agent detector"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    yield checkout
    after = _digests(checkout)
    assert all(after[p] == h for p, h in before.items())


def _run(root, capsys, trace=0, seed=2 ** 40 + 5):
    res = bench_run.run(["--workload", CELL, "--seed", str(seed),
                         "--seconds", "0.3", "--trace", str(trace)],
                        root=root, allow_cpu=True)
    capsys.readouterr()
    return res


def test_single_cell_is_correct(single, capsys):
    res = _run(single, capsys, trace=1)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == {"box_rms", "score_gap", "query_score_rms",
                                  "frames_compared"}
    # a loaded machine may serve one frame in the window
    assert res["checks"]["frames_compared"]["value"] >= 1
    metrics = res["metrics"]
    # the spans around the single detector's stages are read as the coop
    # detector's are, and the program's voxel counter is read
    for name in ("entry.host_ms.eval", "camera.host_ms.eval",
                 "lidar.host_ms.eval", "head.host_ms.eval",
                 "lidar.pillars.eval", "lidar.voxels.eval"):
        assert metrics[name]["value"] > 0, name
    assert metrics["lidar.voxels_dropped.eval"]["value"] == 0
    assert metrics["lidar.pillars_dropped.eval"]["value"] == 0


def test_moved_box_is_not_correct(single, capsys, monkeypatch):
    import cmtcoop_tpu_torch.core.coder as coder
    real = coder.decode_boxes

    def decode(*args, **kwargs):
        dec = real(*args, **kwargs)
        boxes = dec.boxes.clone()
        boxes[:, 0] += 2.0
        return dec._replace(boxes=boxes)

    monkeypatch.setattr(coder, "decode_boxes", decode)
    res = _run(single, capsys, seed=31)
    assert res["correct"] is False
    assert res["checks"]["box_rms"]["value"] > \
        res["checks"]["box_rms"]["limit"]
