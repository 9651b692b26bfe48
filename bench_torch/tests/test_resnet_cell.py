"""A cell of the ResNet single-agent detector end to end on the CPU through
the `eval_closed_resnet` kind: the port's small fusion detector as one
agent with a ResNet-50 + CPFPN camera branch, the six nuScenes task groups
and six 32x64 views (data/tiny_fusion_nusc_r50.json, traffic
data/tiny_eval_single.json with that kind), added to a checkout as new
files and entries, no file of the harness edited. Its run reads correct;
a box moved where the program decodes reads not correct; the control
reads not correct; and the analytic operation count (flops_resnet.py)
equals PyTorch's FlopCounterMode over the plain reference's forward."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import control_resnet, flops_resnet, generator_single
from bench_torch import program
from bench_torch import run as bench_run
from bench_torch.reference_resnet import ResNetReference
from bench_torch.tests.conftest import BENCH, DATA
from bench_torch.weights import make_weights

CELL = "tiny_nusc_r50.eval"
LIKE = "fusion_nusc_r50.eval_b1"
CONF = "tiny_fusion_nusc_r50"


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench_torch").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _traffic():
    traffic = json.loads((DATA / "tiny_eval_single.json").read_text())
    return dict(traffic, kind="eval_closed_resnet")


@pytest.fixture()
def resnet_cell(checkout):
    """The checkout with the small ResNet cell added."""
    before = _digests(checkout)
    d = checkout / "bench_torch"
    cfg = json.loads((DATA / f"{CONF}.json").read_text())
    cfg["dtype"] = "bfloat16"
    (d / "configs" / f"{CONF}.json").write_text(json.dumps(cfg))
    (d / "traffic" / "tiny_eval_r50.json").write_text(json.dumps(_traffic()))
    tiny = json.loads((DATA / "tiny_limits.json").read_text())
    names = json.loads((BENCH / "limits" / f"{LIKE}.json").read_text())
    (d / "limits" / f"{CELL}.json").write_text(
        json.dumps({k: tiny[k] for k in names}))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONF, "source": cfg["source"],
                             "file": f"bench_torch/configs/{CONF}.json",
                             "reduced": [],
                             "why": "the small ResNet single-agent detector"})
    bench["workloads"].append({"name": CELL, "config": CONF,
                               "traffic": "tiny_eval_r50", "chips": 1,
                               "why": "the small ResNet detector"})
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


def test_resnet_cell_is_correct(resnet_cell, capsys):
    res = _run(resnet_cell, capsys, trace=1)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert set(res["checks"]) == {"box_rms", "score_gap", "query_score_rms",
                                  "frames_compared"}
    assert res["checks"]["frames_compared"]["value"] >= 1
    metrics = res["metrics"]
    # device times are read on the card only
    assert "camera.backbone_ms.eval" not in metrics
    for name in ("camera.host_ms.eval", "lidar.host_ms.eval",
                 "head.host_ms.eval", "lidar.pillars.eval",
                 "lidar.voxels.eval"):
        assert metrics[name]["value"] > 0, name
    assert metrics["lidar.voxels_dropped.eval"]["value"] == 0
    assert metrics["lidar.pillars_dropped.eval"]["value"] == 0


def test_moved_box_is_not_correct(resnet_cell, capsys, monkeypatch):
    import cmtcoop_tpu_torch.core.coder as coder
    real = coder.decode_boxes

    def decode(*args, **kwargs):
        dec = real(*args, **kwargs)
        boxes = dec.boxes.clone()
        boxes[:, 0] += 2.0
        return dec._replace(boxes=boxes)

    monkeypatch.setattr(coder, "decode_boxes", decode)
    res = _run(resnet_cell, capsys, seed=31)
    assert res["correct"] is False
    assert res["checks"]["box_rms"]["value"] > \
        res["checks"]["box_rms"]["limit"]


def test_control_is_not_correct(resnet_cell, capsys):
    """The fp8 control over the ResNet reference, on the CPU at this size,
    is refused by the small cells' limits."""
    readings = control_resnet.main(["--workload", CELL, "--seeds", "7",
                                    "--device", "cpu"], root=resnet_cell)
    capsys.readouterr()
    assert [r["correct"] for r in readings] == [False]


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_analytic_count_equals_the_counter(seed):
    cfg = json.loads((DATA / f"{CONF}.json").read_text())
    cpu = torch.device("cpu")
    shapes = program.state_shapes(
        program.build_eval_model(cfg, torch.device("meta")))
    ref = ResNetReference(cfg, make_weights(shapes, seed, cpu))
    host = generator_single.frame_pool(_traffic(), cfg, seed)[0]
    counts = {"vehicle": ref.active_counts(
        torch.from_numpy(host["points"][0]),
        torch.from_numpy(host["points_mask"][0]))}
    with FlopCounterMode(display=False) as counter:
        ref.frame(host)
    assert flops_resnet.frame_flops(cfg, counts) == \
        counter.get_total_flops()
