"""Where the time of one of the port's main paths goes, read from one
`torch.profiler` trace on the card:

    python -m cmtcoop_tpu_torch.profile_path [--preset NAME] [--out DIR]
    python -m cmtcoop_tpu_torch.profile_path --preset cmt_lidar_coop_tumtraf \
        --encoder gather [--out DIR]
    python -m cmtcoop_tpu_torch.profile_path --train [--out DIR]

Builds the full-width main path of `--preset` (main_path.py `PATHS`; the
flagship `cmt_fusion_coop_tumtraf` by default), runs two frames to warm up
(a new graph key's eager frame and the frame that captures its CUDA graphs,
models/graphs.py), then traces 3 frames. The stages are the program's own spans
(utils/profiling.py `span`), which the trace holds beside the device ops.
`--encoder gather` takes the LiDAR preset with the
gather sparse encoder (main_path.py `GATHER_PATH`), whose stages add
`voxelize` (voxelize + VFE), `sparse maps` (every neighbour map and active
set of the encoder, kernel 9) and `sparse convs` (its gather convs and the
densify); its `pillar encoder` span keeps what these leave. On the pillar
encoder, `pillar maps` holds its calls of `pillar_neighbor_map` and
`pillar_conv_neighbor_map` (kernel 9; the downsample grids stay in `pillar
encoder`). With `--train` it builds the full-width train step
(main_path.py `build_train_path`), runs one step to warm up and traces one
step: the frame is then the step, and the stages add `forward` (what no
finer forward stage holds), `loss + Hungarian`, `backward` (the checkpoint
recomputes included) and `optimizer`, and `stage_host_ms` gives each
stage's host span (the Hungarian's share of the step is the host part of
`loss + Hungarian`). From that one trace it reads, per frame:

- `frame_ms`: the host span of a frame, from its start to its
  synchronisation, profiler on (its per-op host cost lengthens the frame,
  so `untraced_frame_ms`, the mean of as many frames timed on the host
  clock just before the trace, is printed beside it);
- `device_busy_ms` and `idle_share`: the union of the device's kernel, copy
  and memset intervals inside the frame spans, and the share of the spans
  it leaves idle;
- `stage_device_ms`: the device time of each stage, each device op charged
  to the stage whose host span launched it (`rv pe`: the image tokens' and
  the queries' RV position encodings; `other`: the BEV query embedding, the
  fusion and the decode); `stage_launches` the number of those device ops
  (kernels, copies, memsets) and `stage_syncs` the host's CUDA
  synchronize calls inside each stage's span;
- `top_kernels_ms`: the device time of the busiest kernels by name,
  `top_kernel_families_ms` the same summed over each kernel's
  instantiations (the name up to its template or argument list: kernel 4
  is `conv_tc::conv3x3_tc_kernel` in bf16, kernel 6
  `osa_tc::osa_agg_tc_kernel`, kernels 3 and 7 in bf16
  `fwd_tc::fwd_kernel` beside its `merge_kernel`), and `train_kernels_ms`
  that of the flash kernels (`flash_train_*`, `fwd_tc::` and `bwd_tc::`:
  kernel 8 in bf16 is `bwd_tc::dq_kernel` with its `dq_reduce_kernel`,
  and `bwd_tc::dkv_kernel`; in an eval trace the `fwd_tc::` entries are
  kernel 3's launches).

It prints the summary as JSON and writes it, with the Chrome trace, to
`--out` (default `build/profile/` in the checkout).
"""
from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from cmtcoop_tpu_torch import main_path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the program's stage spans (utils/profiling.py `span`): per agent (an
# extractor without the module, a LiDAR-only or camera-only model, has no
# such span), then the pillar encoder's neighbour-map builders
# (ops/pillars.py), then the head's
AGENT_STAGES = ("image backbone", "image neck", "pillarize", "pillar encoder",
                "SECOND", "FPN")
PILLAR_MAPS = "pillar maps"
HEAD_STAGES = ("head memory", "rv pe", "decoder", "task heads")
STAGES = AGENT_STAGES + (PILLAR_MAPS,) + HEAD_STAGES
# the gather encoder's own spans (models/detector.py, sparse_encoder.py)
GATHER_STAGES = ("voxelize", "sparse maps", "sparse convs")
# the train step's own spans (train/train_step.py `make_train_step`)
TRAIN_STAGES = ("forward", "loss + Hungarian", "backward", "optimizer")
N_FRAMES = 3


def _union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def kernel_family(name: str) -> str:
    """A kernel's name without `void`, template arguments or parameters."""
    name = name.removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)].rstrip() if cut else name


def summarize(trace: dict, n_frames: int, stage_names=STAGES) -> dict:
    """Per-frame numbers from a Chrome trace of `n_frames` frames, each
    inside a host span named `frame` (times in the trace are us); device
    ops charged to the innermost of the `stage_names` spans that launched
    them."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                    if e["name"] == "frame")
    if len(frames) != n_frames:
        raise ValueError(f"trace holds {len(frames)} frame spans, not "
                         f"{n_frames}")
    stages = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
              if e["name"] in stage_names]
    host_us = defaultdict(float)
    for s0, s1, name in stages:
        host_us[name] += s1 - s0
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    starts = [f[0] for f in frames]

    def owner(t):
        """The innermost stage whose host span holds time t."""
        owners = [s for s in stages if t is not None and s[0] <= t < s[1]]
        return min(owners, key=lambda s: s[1] - s[0])[2] if owners \
            else "other"

    def in_frames(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < frames[i][1] else None

    busy, stage_us, kernel_us = [], defaultdict(float), defaultdict(float)
    stage_ops, stage_syncs = defaultdict(int), defaultdict(int)
    for e in events:
        if (e.get("cat") in LAUNCH_CATS and "Synchronize" in e["name"]
                and in_frames(e["ts"]) is not None):
            stage_syncs[owner(e["ts"])] += 1
        if e.get("cat") not in DEVICE_CATS:
            continue
        i = in_frames(e["ts"])
        if i is None:
            continue  # outside the traced frames
        busy.append((e["ts"], min(e["ts"] + e["dur"], frames[i][1])))
        stage = owner(launched.get(e.get("args", {}).get("correlation")))
        stage_us[stage] += e["dur"]
        stage_ops[stage] += 1
        kernel_us[e["name"]] += e["dur"]
    if not busy:
        raise ValueError("the trace holds no device time inside the frames")
    span_ms = sum(e - s for s, e in frames) / 1e3
    busy_ms = _union_ms(busy)
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:15]
    family_us = defaultdict(float)
    for k, v in kernel_us.items():
        family_us[kernel_family(k)] += v
    families = sorted(family_us.items(), key=lambda kv: -kv[1])[:15]
    return dict(
        frames=n_frames, frame_ms=span_ms / n_frames,
        device_busy_ms=busy_ms / n_frames, idle_share=1 - busy_ms / span_ms,
        stage_device_ms={k: stage_us[k] / 1e3 / n_frames
                         for k in tuple(stage_names) + ("other",)
                         if k in stage_us},
        stage_host_ms={k: host_us[k] / 1e3 / n_frames for k in stage_names
                       if k in host_us},
        stage_launches={k: stage_ops[k] / n_frames for k in
                        tuple(stage_names) + ("other",) if k in stage_ops},
        stage_syncs={k: stage_syncs[k] / n_frames for k in
                     tuple(stage_names) + ("other",) if k in stage_syncs},
        top_kernels_ms={k: v / 1e3 / n_frames for k, v in top},
        top_kernel_families_ms={k: v / 1e3 / n_frames for k, v in families},
        train_kernels_ms={k: v / 1e3 / n_frames for k, v in kernel_us.items()
                          if "flash_train" in k or "bwd_tc::" in k
                          or "fwd_tc::" in k})


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default=main_path.FUSION_PRESET,
                        choices=main_path.PATHS)
    parser.add_argument("--encoder", default="pillar",
                        choices=("pillar", "gather"),
                        help="the LiDAR preset's sparse encoder")
    parser.add_argument("--train", action="store_true",
                        help="trace one full-width train step instead")
    parser.add_argument("--out", default=str(
        Path(__file__).resolve().parents[1] / "build" / "profile"))
    args = parser.parse_args(argv)
    path = args.preset
    if args.encoder == "gather":
        if args.preset != main_path.PRESET or args.train:
            parser.error(f"--encoder gather takes --preset "
                         f"{main_path.PRESET} and no --train")
        path = main_path.GATHER_PATH
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: needs a CUDA device")
    dev = torch.device("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    if args.train:
        _, batch, _, step = main_path.build_train_path(dev)
        n, stage_names = 1, STAGES + TRAIN_STAGES
        step(batch)  # warm-up: the build, first launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("frame"):
                step(batch)
                torch.cuda.synchronize()
    else:
        model, batch = main_path.build_main_path(dev, path)
        n, stage_names = N_FRAMES, STAGES + GATHER_STAGES
        with torch.inference_mode():
            for _ in range(2):  # warm-up: the build, launches, graphs
                main_path.frame(model, batch)
            t0 = time.perf_counter()
            for _ in range(n):
                main_path.frame(model, batch)
            untraced_ms = (time.perf_counter() - t0) * 1e3 / n
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    with torch.profiler.record_function("frame"):
                        main_path.frame(model, batch)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace.json"
    prof.export_chrome_trace(str(trace_path))
    summary = summarize(json.loads(trace_path.read_text()), n, stage_names)
    summary["preset"] = main_path.TRAIN_PATH if args.train else path
    summary["untraced_frame_ms"] = untraced_ms
    if args.train:
        summary["traced_peak_memory_gib"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)
    summary["card"] = _card()
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
