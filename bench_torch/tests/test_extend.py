"""A cell, a traffic mix, a per-layer metric and a kernel's work file
added as new files (and entries in BENCHMARK.json), in a copy of a
checkout, are found by name, with no file of the harness edited; the
older cell's run does not take up the new work file."""
from __future__ import annotations

import hashlib
import json

from bench_torch import run as bench_run
from bench_torch.run import load_file

METRIC = '''"""Host ms a frame of the copy-in alone."""


def read(run):
    return run.trace.host_ms(["entry.copy_in"])
'''


WORK = '''"""Work of one copy-in: the bytes of the frame's arrays."""

TARGETS = (("cmtcoop_tpu_torch.train.eval_hook", "to_device"),)


def work(args, kwargs, out):
    return 0, sum(v.nbytes for v in args[0].values())
'''

WORK_METRIC = '''"""Copy-in calls a traced frame (work/copy_in.py)."""

WORK = "copy_in"


def read(run):
    calls = run.work.get(WORK)
    return len(calls) / run.trace.n_frames if calls else None
'''


def work_files(cell):
    return load_file(cell.kind_dir / "eval_closed.py").work_files(cell)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench_torch").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_traffic_and_metric_are_found_by_name(checkout, capsys):
    before = _digests(checkout)
    d = checkout / "bench_torch"
    traffic = json.loads((d / "traffic" / "tiny_eval.json").read_text())
    traffic.update(pool=3, why="three distinct frames")
    (d / "traffic" / "tiny_eval_pool3.json").write_text(json.dumps(traffic))
    (d / "metrics" / "entry.copy_ms.eval.py").write_text(METRIC)
    (d / "work" / "copy_in.py").write_text(WORK)
    (d / "metrics" / "copy_in.calls.eval.py").write_text(WORK_METRIC)
    (d / "limits" / "tiny_fusion.pool3.json").write_text(
        (d / "limits" / "tiny_fusion.eval.json").read_text())
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_fusion.pool3",
                               "config": "tiny_fusion_coop",
                               "traffic": "tiny_eval_pool3", "chips": 1,
                               "why": "a mix added as a data file"})
    bench["per_layer"].append({
        "name": "entry.copy_ms.eval", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "eval entry",
        "moves": "frame_ms", "workloads": ["tiny_fusion.pool3"]})
    bench["per_layer"].append({
        "name": "copy_in.calls.eval", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "eval entry",
        "moves": "frame_ms", "workloads": ["tiny_fusion.pool3"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    res = bench_run.run(["--workload", "tiny_fusion.pool3", "--seed", "4",
                         "--seconds", "1", "--trace", "1"], root=checkout,
                        allow_cpu=True)
    capsys.readouterr()
    assert res["correct"] is True
    assert res["metrics"]["entry.copy_ms.eval"]["value"] > 0
    assert res["metrics"]["copy_in.calls.eval"]["value"] == 1
    assert res["checks"]["frames_compared"]["value"] >= 3
    # the older cell does not report the new metric
    old = bench_run.run(["--workload", "tiny_fusion.eval", "--seed", "4",
                         "--seconds", "0.2", "--trace", "1"], root=checkout,
                        allow_cpu=True)
    capsys.readouterr()
    assert "entry.copy_ms.eval" not in old["metrics"]
    assert "copy_in.calls.eval" not in old["metrics"]
    cells = {n: bench_run.load_cell(n, checkout)
             for n in ("tiny_fusion.eval", "tiny_fusion.pool3")}
    assert [p.stem for p in work_files(cells["tiny_fusion.pool3"])] == [
        "conv3x3", "copy_in", "flash"]
    assert "copy_in" not in [p.stem
                             for p in work_files(cells["tiny_fusion.eval"])]
    after = _digests(checkout)
    assert all(after[p] == h for p, h in before.items())
