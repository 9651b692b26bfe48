"""The readers of the program's CUDA-graph counters (`graph_share.eval`,
`graph_pool_gib.eval`) on a hand-driven recorder, and None from each where
the program counts no graph segments."""
from __future__ import annotations

import json

import pytest
import torch

from bench_torch import program_spans
from bench_torch.run import load_file
from bench_torch.tests.conftest import BENCH
from cmtcoop_tpu_torch.utils.profiling import Recorder

NAMES = ("graph_share.eval", "graph_pool_gib.eval")


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py").read


def recorder(frames):
    """Each frame's counts made while a profiler records, as the program's
    `Frame.finish` makes them: {counter: value} a frame."""
    rec = Recorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for counts in frames:
            for name, value in counts.items():
                rec.count(name, value)
    return rec


def frame(replayed, eager, pool):
    return {"graph.replayed": replayed, "graph.eager": eager,
            "graph.pool_bytes": pool}


@pytest.mark.parametrize("frames,share,gib", [
    # the capture frame (28 segments on the host), then a replayed one
    ([frame(0, 28, 2 ** 29), frame(28, 0, 3 * 2 ** 29)], 50.0, 1.5),
    ([frame(28, 0, 2 ** 29)] * 4, 100.0, 0.5),
    # a path that cannot replay (the CPU, train mode, the gather encoder)
    ([frame(0, 28, 0)] * 4, 0.0, 0.0),
])
def test_graph_share_and_pool(monkeypatch, frames, share, gib):
    monkeypatch.setattr(program_spans, "recorder", lambda: recorder(frames))
    assert reader("graph_share.eval")(None) == pytest.approx(share)
    assert reader("graph_pool_gib.eval")(None) == pytest.approx(gib)


def test_a_program_without_the_counters_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: recorder([{"h2d.bytes": 4000}]))
    for name in NAMES:
        assert reader(name)(None) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    for name in NAMES:
        assert reader(name)(None) is None


def test_the_readers_are_in_the_benchmark():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        assert entries[name]["workloads"] == ["fusion_coop.eval_b1"]
        assert entries[name]["moves"] == "frame_ms"
        assert entries[name]["layer"] == "device"
