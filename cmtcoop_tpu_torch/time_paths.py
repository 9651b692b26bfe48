"""Frame (or train step) times of two checkouts of the repository,
alternated on one card: does a change move a main path's ms/frame beyond
the host clock's spread?

    python -m cmtcoop_tpu_torch.time_paths --base <other checkout> \\
        [--preset cmt_lidar_coop_tumtraf ...] [--rounds 6] [--frames 5]

One worker process per checkout (this one and `--base`, e.g. the parent
commit unpacked with `git archive` into `build/`) imports that checkout's
`cmtcoop_tpu_torch.main_path`, builds each path's full-width model and batch
once (`build_main_path`, or `build_train_path` for `main_path.TRAIN_PATH`;
seeded) and runs a warm-up frame or step. Each round then times `--frames`
frames (`main_path.frame`) or steps of every path in each worker, host
clock to synchronize, in the order base, this, this, base, ... so that
drift over the call falls on both alike. Prints one JSON object: per path
and checkout every frame's ms and their median, and the card's `nvidia-smi`
name and power limit. `--preset` takes any of `main_path.PATHS`,
`main_path.GATHER_PATH` and `main_path.TRAIN_PATH` (the LiDAR path by
default).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def worker(root: str) -> None:
    """Serves one checkout: reads a path name per line, answers with one
    JSON line of that path's frame times."""
    sys.path[0] = root  # this checkout's package, not the caller's
    import time

    import torch

    from cmtcoop_tpu_torch import main_path
    dev = torch.device("cuda")

    def runner(preset):
        if preset == main_path.TRAIN_PATH:
            _, batch, _, step = main_path.build_train_path(dev)

            def run():
                step(batch)
                torch.cuda.synchronize()
        else:
            model, batch = main_path.build_main_path(dev, preset)

            def run():
                with torch.inference_mode():
                    main_path.frame(model, batch)
        run()  # warm-up, the build
        return run

    runs = {}
    for line in sys.stdin:
        preset, frames = line.split("\t")
        if preset not in runs:
            runs[preset] = runner(preset)
        times = []
        for _ in range(int(frames)):
            t0 = time.perf_counter()
            runs[preset]()
            times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(times), flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True,
                        help="root of the checkout to compare against")
    parser.add_argument("--preset", action="append",
                        help="a path to time (repeatable)")
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--frames", type=int, default=5)
    args = parser.parse_args(argv)
    presets = args.preset or ["cmt_lidar_coop_tumtraf"]
    roots = {"base": str(Path(args.base).resolve()), "this": str(REPO)}
    procs = {k: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker", root],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for k, root in roots.items()}
    times = {p: {k: [] for k in roots} for p in presets}
    try:
        for r in range(args.rounds):
            order = ("base", "this") if r % 2 == 0 else ("this", "base")
            for p in presets:
                for k in order:
                    procs[k].stdin.write(f"{p}\t{args.frames}\n")
                    procs[k].stdin.flush()
                    line = procs[k].stdout.readline()
                    if not line:
                        raise RuntimeError(f"time_paths: the {k} worker "
                                           f"({roots[k]}) ended")
                    times[p][k] += json.loads(line)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=300)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = dict(card=card, roots=roots, rounds=args.rounds,
               frames=args.frames, paths={
                   p: {k: dict(ms=v, median_ms=statistics.median(v))
                       for k, v in t.items()} for p, t in times.items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main()
