"""Traffic kind `eval_closed_single`: `eval_closed` for a single-agent
detector (the program's `CmtDetector`, one cloud and its views, any number
of task groups): one client in a closed loop at batch 1, cycling a pool of
`pool` distinct frames from the seed (generator_single.py), each frame's
arrays on the host until the program's `to_device` takes them, its boxes
on the host when it ends.

As `eval_closed`: set-up builds the model on the card with the seed's
weights, draws the pool, counts each pool frame's active sets against the
configuration's caps (a frame over a cap counts as failed and is not
compared) and serves every pool frame once to warm up; the window serves
frames until `--seconds` have passed, each timed on the host clock; with
`--trace 1` the layers' spans (the same names as `eval_closed`'s, put
around the single detector's stages) and the kernels' work records go in
only after the window, and a few frames run under the profiler. Then the
program is freed, the single-agent reference (reference_single.py) answers
every pool frame that was served, and a sample of the served frames drawn
from the seed is compared; every served frame is checked for numbers that
are not finite. The decode keeps the boxes inside the configuration's
`post_center_range`, as the program's eval does for its preset.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_torch import compare, flops, generator_single, peaks, program
from bench_torch import trace
from bench_torch.kinds.eval_closed import (COMPARED_PER_POOL_FRAME,
                                           TRACED_FRAMES, caps_exceeded,
                                           install_work, no_span, restore)
from bench_torch.reference_single import SingleReference
from bench_torch.weights import make_weights

AGENT = "vehicle"  # the configuration's one agent, as `flops.py` reads it


def eval_server(model, config: dict, device, span):
    """serve(host frame) -> the frame's boxes on the host, as
    `program.eval_server` makes them, decoded with the configuration's
    `max_num` and `post_center_range`."""
    from cmtcoop_tpu_torch.core.coder import decode_boxes
    from cmtcoop_tpu_torch.data.formats import decoded_to_eval_boxes
    from cmtcoop_tpu_torch.train.eval_hook import (make_eval_forward,
                                                   to_device)
    forward = make_eval_forward(model)
    names = program.preset(config).class_names
    head = config["head"]
    centre_range = tuple(head["post_center_range"])

    def serve(host, timestamp: int = 0):
        with span("entry.copy_in"):
            batch = to_device(host, device)
        logits, codes = forward(batch)
        with span("entry.decode"):
            dec = decode_boxes([lg[0] for lg in logits],
                               [c[0] for c in codes], head["max_num"],
                               post_center_range=centre_range)
            return decoded_to_eval_boxes(dec, names, timestamp)

    return serve


def instrument(model) -> None:
    """`trace.instrument` on the single detector: its stages are the
    extractor's, at the top level of the model."""
    trace.instrument(SimpleNamespace(agents=("single",), single_model=model,
                                     pts_bbox_head=model.pts_bbox_head))


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
    pool = generator_single.frame_pool(traffic, cfg, args.seed)
    phase("pool")
    counter = SingleReference(cfg, {})
    counts = [{AGENT: counter.active_counts(
        torch.as_tensor(host["points"][0]).to(device),
        torch.as_tensor(host["points_mask"][0]).to(device))}
        for host in pool]
    dropped = [caps_exceeded(cfg, c) for c in counts]
    pool_flops = [flops.frame_flops(cfg, c) for c in counts]
    print("active sets: " + "; ".join(
        f"voxels {c[AGENT]['voxels']}, pillars {c[AGENT]['pillars']}"
        for c in counts), file=sys.stderr)
    phase("counts")
    serve = eval_server(model, cfg, device, no_span)
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
        instrument(model)
        wrapped = install_work(cell, records)
        serve = eval_server(model, cfg, device,
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
    ref = SingleReference(cfg, make_weights(shapes, args.seed, device))
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
