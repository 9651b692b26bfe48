"""Traffic kind `eval_closed`: one client in a closed loop at the traffic
file's `batch` (1), cycling a pool of `pool` distinct frames from the seed
(generator.py), each frame's arrays on the host until the program's
`to_device` takes them, its boxes on the host when it ends.

Set-up: the model on the card with the seed's weights, the pool, each
pool frame's active sets against the configuration's caps (a frame whose
cloud would lose a voxel or a pillar counts as failed and is not
compared), one pass over the pool to warm up. The window: frames until
`--seconds` have passed, each timed on the host clock from its hand-over
to its boxes. With `--trace 1` the window runs untraced as ever; only
after it are the layers' spans and the kernels' work records put in, and
a few frames run under the profiler. Then the program is freed, the
reference answers every pool frame that was served, and a sample of the
served frames drawn from the seed (`COMPARED_PER_POOL_FRAME` of each pool
frame) is compared; every served frame is checked for numbers that are
not finite.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import importlib
import json
import os
import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_torch import compare, flops, generator, peaks, program, trace
from bench_torch.reference import Reference
from bench_torch.weights import make_weights

TRACED_FRAMES = 4
# served frames compared a pool frame, drawn from the seed: the answers of
# one pool frame agree to the rounding of the program's atomics, and the
# comparison of a whole window would outlast it
COMPARED_PER_POOL_FRAME = 8


def caps_exceeded(config: dict, counts: dict) -> bool:
    """True where a cloud holds more voxels than `max_voxels` or more
    active BEV cells at a level than that level's pillar cap."""
    li = config["lidar"]
    for c in counts.values():
        if c["voxels"][0] > li["max_voxels"]:
            return True
        if any(n > cap for n, cap in zip(c["pillars"], li["pillar_caps"])):
            return True
    return False


def work_files(cell) -> list:
    """The `work/<name>.py` files that the cell's own per-layer metrics
    read (each roofline reader names its `WORK`), so that a work file
    added for another cell leaves this cell's run as it was."""
    from bench_torch.run import load_file
    names = set()
    for m in cell.per_layer:
        reader = load_file(cell.metric_dir / f"{m['name']}.py")
        if getattr(reader, "WORK", None):
            names.add(reader.WORK)
    return [cell.work_dir / f"{name}.py" for name in sorted(names)]


def install_work(cell, records: dict) -> list:
    """Wrap the target functions of the cell's work files (`work_files`):
    each call runs inside a `work.<name>` span and its (operations, bytes)
    go to `records[name]`. Returns what `restore` puts back."""
    from bench_torch.run import load_file
    saved = []
    for path in work_files(cell):
        mod = load_file(path)
        name = path.stem
        records[name] = []
        for module, attr in mod.TARGETS:
            owner = importlib.import_module(module)
            fn = getattr(owner, attr)

            def wrapped(*args, _fn=fn, _mod=mod, _name=name, **kwargs):
                with torch.profiler.record_function("work." + _name):
                    out = _fn(*args, **kwargs)
                records[_name].append(_mod.work(args, kwargs, out))
                return out

            saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
    return saved


def restore(saved: list) -> None:
    for owner, attr, fn in reversed(saved):
        setattr(owner, attr, fn)


def no_span(name: str):
    return contextlib.nullcontext()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, args, device, t_start: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    # -- set-up ------------------------------------------------------------
    phases = [("import", time.time() - t_start)]
    tp = time.perf_counter()

    def phase(name):
        nonlocal tp
        now = time.perf_counter()
        phases.append((name, now - tp))
        tp = now

    model = program.build_eval_model(cfg, device)
    shapes = program.state_shapes(model)
    program.load_weights(model, make_weights(shapes, args.seed, device))
    _sync(device)
    phase("model")
    pool = generator.frame_pool(traffic, cfg, args.seed)
    phase("pool")
    counter = Reference(cfg, {})
    counts = []
    for host in pool:
        counts.append({a: counter.active_counts(
            torch.as_tensor(host[f"{a}_points"][0]).to(device),
            torch.as_tensor(host[f"{a}_points_mask"][0]).to(device))
            for a in cfg["agents"]})
    dropped = [caps_exceeded(cfg, c) for c in counts]
    pool_flops = [flops.frame_flops(cfg, c) for c in counts]
    phase("counts")
    serve = program.eval_server(model, cfg, device, no_span)
    for host in pool:  # warm-up: every frame of the pool once
        serve(host)
    _sync(device)
    phase("warm-up")
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # -- the window --------------------------------------------------------
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    times, served = [], []
    n = 0
    while True:
        i = n % len(pool)
        a = time.perf_counter()
        boxes = serve(pool[i], n)
        b = time.perf_counter()
        times.append(b - a)
        served.append((i, boxes))
        n += 1
        if b - t0 >= args.seconds:
            break
    window_s = b - t0
    q = np.percentile(times, [5, 25, 50, 75, 95, 99]) * 1e3
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases)
          + f"; frames {n}, ms p5 p25 p50 p75 p95 p99: "
          + " ".join(f"{v:.2f}" for v in q), file=sys.stderr)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    end_to_end = {"frame_ms": window_s * 1e3 / n, "setup_s": setup_s}
    if cuda:
        end_to_end["peak_mem_gib"] = peak_window / 2 ** 30
    out = {"attempted": n, "end_to_end": end_to_end,
           "memory_peak_bytes": max(peak_setup, peak_window)}
    # -- the traced frames -------------------------------------------------
    wrapped, records = [], {}
    if args.trace:
        # the window ran the untraced code; the spans and the work records
        # go in only now
        trace.instrument(model)
        wrapped = install_work(cell, records)
        serve = program.eval_server(model, cfg, device,
                                    torch.profiler.record_function)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1,
                                        active=TRACED_FRAMES, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for k in range(TRACED_FRAMES + 1):
                if k == 1:  # the profiler's warm-up frame is not read
                    for calls in records.values():
                        calls.clear()
                with torch.profiler.record_function(trace.FRAME):
                    serve(pool[(n + k) % len(pool)], n + k)
                prof.step()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                tr = trace.Trace(json.load(f))
        del prof
        seen = [p for p, _ in served]
        out["ctx"] = SimpleNamespace(
            trace=tr, work=records, config=cfg,
            peak=(peaks.peaks(torch.cuda.get_device_name(device)) if cuda
                  else None),
            frame_s=window_s / n, frame_times_s=times,
            flops_per_frame=statistics.fmean(pool_flops[p] for p in seen))
        out["breakdown"] = tr.breakdown()
    # -- the comparison ----------------------------------------------------
    restore(wrapped)
    del serve, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(cfg, make_weights(shapes, args.seed, device))
    answers = {}
    for p in sorted({p for p, _ in served if not dropped[p]}):
        answers[p] = ref.frame(pool[p])
    names = program.preset(cfg).class_names
    rng = np.random.default_rng(np.random.SeedSequence([args.seed, 1]))
    sample = []
    for p in sorted(answers):
        mine = [k for k, (q, _) in enumerate(served) if q == p]
        sample += list(rng.choice(mine, min(len(mine),
                                            COMPARED_PER_POOL_FRAME),
                                  replace=False))
    worst = dict.fromkeys(compare.NAMES, 0.0)
    broken = sum(not compare.finite(boxes) for _, boxes in served)
    failed = broken + sum(dropped[p] for p, _ in served)
    for k in sorted(sample):
        p, boxes = served[k]
        gaps = compare.frame_gaps(boxes, answers[p], names)
        for name in compare.NAMES:
            worst[name] = max(worst[name], gaps[name])
    compared = len(sample)
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in worst.items()),
          file=sys.stderr)
    limits = {k: float(v) for k, v in cell.limits.items()}
    out["correct"] = (compared > 0 and not broken
                      and compare.verdict(worst, limits))
    out["failed"] = failed
    out["checks"] = compare.checks_line(worst, limits, compared)
    return out
