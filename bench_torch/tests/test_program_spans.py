"""The readers of the program's own spans and counters (`*.host_ms.clock`,
`*.syncs.eval`, `*.launches.eval`, `h2d_gbps.eval`,
`h2d.pageable_share.eval`, `lidar.pillars.eval`,
`lidar.pillars_dropped.eval`)
on a hand-made trace of two frames and a hand-driven recorder, and None
from each where the program has no recorder or the trace none of the
layer's spans."""
from __future__ import annotations

import types
from types import SimpleNamespace

import pytest
import torch

from bench_torch import program_spans
from bench_torch.run import load_file
from bench_torch.tests.conftest import BENCH
from bench_torch.trace import Trace
from cmtcoop_tpu_torch.utils.profiling import Recorder

LAYERS = ("entry", "camera", "lidar", "head")
NEW = ([f"{layer}.{m}" for m in ("host_ms.clock", "syncs.eval",
                                  "launches.eval") for layer in LAYERS]
       + ["h2d_gbps.eval", "lidar.pillars.eval",
          "lidar.pillars_dropped.eval", "h2d.pageable_share.eval"])


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py").read


def ev(cat, name, ts, dur, corr=None):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                args={} if corr is None else {"correlation": corr})


def chrome_trace(entry_spans=True):
    """Two 100-us frames. Each: the copy-in (a 4-us copy), the image
    backbone (a 5-us kernel), pillarize and the pillar encoder (no device
    op, no sync), the head's memory with its RV encoding nested (a 2-us
    kernel and a sync inside), the decoder (a 3-us kernel), the decode,
    the boxes with their readback (a sync), and a sync in no layer."""
    out = []
    for f in range(2):
        o = 100 * f
        spans = [("image backbone", 10, 20), ("pillarize", 30, 10),
                 ("pillar encoder", 40, 10), ("head memory", 50, 20),
                 ("rv pe", 55, 5), ("decoder", 70, 15)]
        if entry_spans:
            spans += [("eval.to_device", 0, 10), ("eval.decode", 85, 5),
                      ("eval.boxes", 90, 8), ("eval.readback", 91, 4)]
        out.append(ev("user_annotation", "frame", o, 100))
        out += [ev("user_annotation", n, o + s, d) for n, s, d in spans]
        for k, (t, cat, name, d) in enumerate((
                (2, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4),
                (12, "kernel", "vov", 5), (56, "kernel", "rv", 2),
                (72, "kernel", "attn", 3))):
            corr = 10 * f + k
            out.append(ev("cuda_runtime", "cudaLaunchKernel", o + t, 1,
                          corr))
            out.append(ev(cat, name, o + t + 1, d, corr))
        out += [ev("cuda_runtime", "cudaStreamSynchronize", o + t, 1)
                for t in (57, 92, 99)]
    return {"traceEvents": out}


def recorder(ring=256, rv_pe=(2, 2)):
    """Untraced frames on a hand-moved clock: a set-up frame, the window's
    two and the profiler's warm-up frame (the outer two ten times as
    slow), then two traced frames, with `rv_pe` calls of the RV encoding
    in each. A frame copies 4000 bytes, 1000 of them pageable."""
    now = [0]
    rec = Recorder(ring=ring, clock=lambda: now[0])

    def call(name, ns, inner=None):
        with rec.span(name):
            now[0] += ns
            if inner:
                call(*inner)

    for slow in (10, 1, 1, 10):
        call("eval.to_device", slow * 1_000_000)
        call("image backbone", slow * 4_000_000)
        call("pillarize", slow * 2_000_000)
        call("head memory", slow * 1_500_000, ("rv pe", slow * 500_000))
        call("rv pe", slow * 300_000)
        call("decoder", slow * 1_000_000)
        rec.count("h2d.bytes", 4000)
        rec.count("h2d.pageable_bytes", 1000)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for f in range(2):
            for name in ("eval.to_device", "image backbone", "pillarize",
                         "head memory", *["rv pe"] * rv_pe[f],
                         "decoder"):
                with rec.span(name):
                    pass
            rec.count("h2d.bytes", 4000)
            rec.count("h2d.pageable_bytes", 1000)
            for agent in range(2):
                rec.count("pillars.l0", torch.tensor(120 - 40 * agent))
                rec.count("pillars.l1", torch.tensor(60 - 20 * agent))
                rec.count("pillars.l2", torch.tensor(30))
    return rec


@pytest.fixture()
def run(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", recorder)
    return SimpleNamespace(trace=Trace(chrome_trace()),
                           config={"lidar": {"pillar_caps": [100, 50]}},
                           frame_times_s=[0.1, 0.1])


def test_clock_readers_take_each_layer_union(run):
    """Mean ms a call over the window's calls (neither the set-up frame
    nor the profiler's warm-up frame) times the calls a traced frame: the
    head's RV encoding inside its memory counts once (0.3 ms a call at
    one of its two calls, 2 calls a frame)."""
    got = {layer: reader(f"{layer}.host_ms.clock")(run) for layer in LAYERS}
    assert got == pytest.approx({"entry": 1.0, "camera": 4.0, "lidar": 2.0,
                                 "head": 2.0 + 0.3 + 1.0})


def test_syncs_and_launches_by_layer(run):
    syncs = {layer: reader(f"{layer}.syncs.eval")(run) for layer in LAYERS}
    assert syncs == {"entry": 1, "camera": 0, "lidar": 0, "head": 1}
    assert sum(syncs.values()) < run.trace.syncs_per_frame() == 3
    launches = {layer: reader(f"{layer}.launches.eval")(run)
                for layer in LAYERS}
    assert launches == {"entry": 1, "camera": 1, "lidar": None, "head": 2}


def test_clock_readers_refuse_a_window_the_ring_has_lost(
        run, monkeypatch):
    """A ring too short for the window's calls and the warm-up frame's,
    or calls a frame that differ between the traced frames, read None:
    not the mean of part of the window."""
    names = ("head.host_ms.clock", "camera.host_ms.clock")
    # the head's RV encoding: 2 a frame, so 4 window calls + 2 of the
    # warm-up frame; 6 of its 8 untraced calls stay in a ring of 6
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: recorder(ring=6))
    assert [reader(n)(run) for n in names] == pytest.approx([3.3, 4.0])
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: recorder(ring=5))
    got = [reader(n)(run) for n in names]
    assert got[0] is None and got[1] == pytest.approx(4.0)
    # 3 calls in one traced frame, 2 in the other
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: recorder(rv_pe=(3, 2)))
    assert reader("head.host_ms.clock")(run) is None


def test_h2d_rate_and_pillar_counts(run):
    # 4000 bytes a frame over the copy's 4 us
    assert reader("h2d_gbps.eval")(run) == pytest.approx(1.0)
    # 1000 of 4000 bytes pageable, over every frame (running totals)
    assert reader("h2d.pageable_share.eval")(run) == pytest.approx(25.0)
    # each level at most its cap (the last cap for level 2), per frame:
    # (100 + 80 + 50 + 40 + 30 + 30) over each of the two frames
    assert reader("lidar.pillars.eval")(run) == pytest.approx(330.0)
    # what the caps leave out a frame: (120 - 100) + (60 - 50)
    assert reader("lidar.pillars_dropped.eval")(run) == pytest.approx(30.0)


def test_a_tree_without_the_recorder_or_the_spans_reads_none(
        run, monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    for name in ("entry.host_ms.clock", "camera.host_ms.clock",
                 "lidar.host_ms.clock", "head.host_ms.clock",
                 "h2d_gbps.eval", "h2d.pageable_share.eval",
                 "lidar.pillars.eval", "lidar.pillars_dropped.eval"):
        assert reader(name)(run) is None, name
    # the harness's own stage spans stay; the eval entry's are the
    # program's alone
    run.trace = Trace(chrome_trace(entry_spans=False))
    assert reader("entry.syncs.eval")(run) is None
    assert reader("entry.launches.eval")(run) is None
    assert reader("camera.launches.eval")(run) == 1


def test_recorder_is_none_for_a_program_without_one(monkeypatch):
    import cmtcoop_tpu_torch.utils as utils
    assert program_spans.recorder() is not None
    monkeypatch.setattr(utils, "profiling",
                        types.ModuleType("cmtcoop_tpu_torch.utils.profiling"))
    assert program_spans.recorder() is None


def test_every_new_reader_is_in_the_benchmark():
    import json
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == ["fusion_coop.eval_b1"]
        assert entries[name]["moves"] == "frame_ms"
        assert (BENCH / "metrics" / f"{name}.py").is_file()
