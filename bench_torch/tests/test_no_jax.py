"""No module of the harness imports JAX, flax or the JAX package, in a
fresh process that imports every one of them and runs a small cell."""
from __future__ import annotations

import subprocess
import sys

from bench_torch.tests.conftest import BENCH, REPO

SCRIPT = r"""
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from bench_torch import run
from bench_torch.tests.conftest import make_checkout
bench = Path({bench!r})
for sub in ("kinds", "metrics", "work"):
    for p in sorted((bench / sub).glob("*.py")):
        run.load_file(p)
for name in ("compare", "control", "flops", "generator", "peaks", "program",
             "reference", "trace", "weights"):
    __import__("bench_torch." + name)
root = make_checkout(Path({tmp!r}))
assert run.run(["--workload", "tiny_lidar.eval", "--seed", "9",
                "--seconds", "0.2", "--trace", "1"], root=root,
               allow_cpu=True)["correct"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cmtcoop_tpu"))
print("IMPORTED", bad)
"""


def test_fresh_process_imports_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=str(REPO),
                                             bench=str(BENCH),
                                             tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED []" in out.stdout
