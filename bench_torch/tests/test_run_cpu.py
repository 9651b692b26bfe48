"""A small cell end to end on the CPU: the contract's last line, the CPU
named as the device, no device metric; a seeded run is repeatable; the
`--trace 1` line carries only what the CPU can read."""
from __future__ import annotations

import json

import pytest

from bench_torch import run as bench_run

DEVICE_METRICS = ("peak_mem_gib",)


def _run(checkout, capsys, cell="tiny_fusion.eval", seed=2 ** 40 + 3,
         trace=0):
    res = bench_run.run(["--workload", cell, "--seed", str(seed),
                         "--seconds", "0.5", "--trace", str(trace)],
                        root=checkout, allow_cpu=True)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(res))
    return last, err


@pytest.mark.parametrize("cell", ["tiny_fusion.eval", "tiny_lidar.eval"])
def test_cell_prints_the_contract_line(checkout, capsys, cell):
    last, err = _run(checkout, capsys, cell)
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert last["device"]["platform"] == "cpu"
    assert last["device"]["kind"] == "cpu"
    assert set(last["metrics"]) == {"frame_ms", "setup_s"}
    assert not set(last["metrics"]) & set(DEVICE_METRICS)
    for m in last["metrics"].values():
        assert m["value"] > 0
    # each number compared, beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {k}"
                                              for k in last["checks"]]


def test_trace_run_on_the_cpu_reads_no_device_metric(checkout, capsys):
    last, _ = _run(checkout, capsys, trace=1)
    assert last["correct"] is True
    names = set(last["metrics"])
    assert "entry.host_ms.eval" in names and "head.host_ms.eval" in names
    assert last["metrics"]["frame_ms_p95"]["value"] > 0
    assert not any(".device_ms" in n or "roofline" in n or "mfu" in n
                   or "idle" in n for n in names)
    assert "busy_s" not in last["device"]


def test_same_seed_same_answer(checkout, capsys):
    a, _ = _run(checkout, capsys, seed=77)
    b, _ = _run(checkout, capsys, seed=77)
    # every number compared; how many frames were served may differ
    a["checks"].pop("frames_compared")
    b["checks"].pop("frames_compared")
    assert a["checks"] == b["checks"]


def test_no_card_no_result(checkout, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.run(["--workload", "tiny_fusion.eval", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         root=checkout) is None
    assert capsys.readouterr().out == ""
