"""The benchmark of the PyTorch and CUDA port (`cmtcoop_tpu_torch`):

    python -m bench_torch.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds `BENCHMARK.json`. The cell
names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`, whose `kind` names the code that runs it,
`kinds/<kind>.py`); every per-layer metric is read by its own file,
`metrics/<name>.py`. The run builds the program's model on the card, fills
it with weights from the seed, makes the traffic from the seed, warms up,
measures for `--seconds`, then compares what it served with the plain
reference (`reference.py`). The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside
its limit (also the last lines of standard error).

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def load_file(path: Path) -> ModuleType:
    """A module of the harness's by its file (names may hold dots)."""
    name = "bench_torch._by_file." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell `workload` of `root/BENCHMARK.json`: its entry, its
    configuration and traffic files, its limits, and the end-to-end and
    per-layer metric entries it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / BENCH.name

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, entry=w, root=root,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((bench_dir / "limits" / f"{workload}.json")
                          .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if here(m)],
        per_layer=[m for m in bench["per_layer"] if here(m)],
        metric_dir=bench_dir / "metrics", kind_dir=bench_dir / "kinds",
        work_dir=bench_dir / "work", run_seconds=bench["run_seconds"])


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own kernel library goes to `<root>/build/`."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")


def device_info(device, count: int) -> Dict[str, object]:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def read_metrics(cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_file(cell.metric_dir / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(argv: Optional[List[str]] = None, root: Path = ROOT,
        allow_cpu: bool = False) -> Optional[dict]:
    """One run; returns the result it printed (None where it printed
    none). `allow_cpu` lets the self-tests run a cell on the CPU."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be >= 0")
    cell = load_cell(args.workload, root)
    set_caches(root)
    import torch
    chips = int(cell.entry.get("chips", 1))
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda", 0)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print(f"bench_torch: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return None
    kind = load_file(cell.kind_dir / f"{cell.traffic['kind']}.py")
    res = kind.run(cell, args, device, T_START)
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"]}
    if args.trace:
        metrics = read_metrics(cell, res["ctx"])
    else:
        metrics = {m["name"]: {"value": float(res["end_to_end"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in res["end_to_end"]}
    result["metrics"] = metrics
    dev = device_info(device, chips)
    dev["memory_peak_bytes"] = int(res.get("memory_peak_bytes",
                                           dev["memory_peak_bytes"]))
    if args.trace and device.type == "cuda":
        dev["busy_s"] = res["ctx"].trace.busy_s()
        dev["window_s"] = res["ctx"].trace.window_s()
    result["device"] = dev
    if args.trace and "breakdown" in res:
        result["breakdown"] = res["breakdown"]
    if device.type == "cuda":
        result["card"] = power_limit()
    result["checks"] = res["checks"]
    for k, v in res["checks"].items():
        print(f"check {k}: {v}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    sys.exit(0 if run() is not None else 2)


if __name__ == "__main__":
    main()
