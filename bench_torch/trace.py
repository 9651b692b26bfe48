"""Spans around the program's layers, and the reduction of one
`torch.profiler` trace to what the per-layer metrics read.

`instrument` is a copy of `instrument` in the port's
`cmtcoop_tpu_torch/profile_path.py`: each stage's entry of a cooperative
detector, wrapped from outside in a named host span (what the model
computes does not change). `Trace` takes up that module's `summarize`:
device ops (kernels, copies, memsets) are charged, by the correlation id of
their launch, to every span that was open on the host when they were
launched, so a layer reads the union of its spans.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FRAME = "frame"
# host span name -> (module attribute, method), per agent
AGENT_STAGES = {"image backbone": ("img_backbone", "forward"),
                "image neck": ("img_neck", "forward"),
                "pillarize": ("", "pillarize"),
                "pillar encoder": ("pts_middle_encoder", "forward"),
                "SECOND": ("pts_backbone", "forward"),
                "FPN": ("pts_neck", "forward")}
# host span name -> the head's methods
HEAD_STAGES = {"head memory": ("build_memory",),
               "rv pe": ("_rv_pe", "_rv_query_embed"),
               "decoder": ("run_decoder",), "task heads": ("run_task_heads",)}
PILLAR_MAPS = "pillar maps"
PILLAR_MAP_FNS = ("pillar_neighbor_map", "pillar_conv_neighbor_map")


def _spanned(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _map_spanned(fn, ops):
    def wrapped(*args, **kwargs):
        saved = {n: getattr(ops, n) for n in PILLAR_MAP_FNS}
        for n, f in saved.items():
            setattr(ops, n, _spanned(PILLAR_MAPS, f))
        try:
            return fn(*args, **kwargs)
        finally:
            for n, f in saved.items():
                setattr(ops, n, f)
    return wrapped


def instrument(model) -> None:
    """Wrap each stage's entry of a coop detector in a named host span, and
    the pillar encoder's map builders in `PILLAR_MAPS` spans during its
    forward. Only instance attributes change; what the model computes does
    not."""
    for agent in model.agents:
        ext = getattr(model, f"{agent}_model")
        for name, (sub, method) in AGENT_STAGES.items():
            obj = getattr(ext, sub, None) if sub else ext
            if obj is not None and hasattr(obj, method):
                setattr(obj, method, _spanned(name, getattr(obj, method)))
        enc = getattr(ext, "pts_middle_encoder", None)
        ops = getattr(sys.modules[type(enc).__module__], "pu", None)
        if ops is not None and all(hasattr(ops, n) for n in PILLAR_MAP_FNS):
            enc.forward = _map_spanned(enc.forward, ops)
    head = model.pts_bbox_head
    for name, methods in HEAD_STAGES.items():
        for method in methods:
            setattr(head, method, _spanned(name, getattr(head, method)))


def kernel_family(name: str) -> str:
    """A kernel's name without `void`, template arguments or parameters."""
    name = name.removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)].rstrip() if cut else name


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """One Chrome trace of `n_frames` frames, each inside a host span named
    `frame`; times in the trace are us, what this class returns is ms a
    frame unless it says otherwise."""

    def __init__(self, trace: dict):
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        spans = [e for e in events if e.get("cat") == "user_annotation"]
        self.frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                             if e["name"] == FRAME)
        if not self.frames:
            raise ValueError("the trace holds no frame span")
        self.n_frames = len(self.frames)
        self._starts = [f[0] for f in self.frames]
        self.spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                      if e["name"] != FRAME and self._frame_of(e["ts"])
                      is not None]
        s0 = np.array([s[0] for s in self.spans] or [0.0])
        s1 = np.array([s[1] for s in self.spans] or [0.0])
        names = [s[2] for s in self.spans]
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        self.syncs = [e["ts"] for e in events
                      if e.get("cat") in LAUNCH_CATS
                      and "Synchronize" in e["name"]
                      and self._frame_of(e["ts"]) is not None]
        # device ops inside the frames: (start, end, name, owner span names)
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            i = self._frame_of(e["ts"])
            if i is None:
                continue
            t = launched.get(e.get("args", {}).get("correlation"))
            owners = frozenset()
            if t is not None and self.spans:
                hit = (s0 <= t) & (t < s1)
                owners = frozenset(names[j] for j in np.nonzero(hit)[0])
            self.ops.append((e["ts"], min(e["ts"] + e["dur"],
                                          self.frames[i][1]),
                             e["name"], owners, e["dur"]))
        self.window_us = self.frames[-1][1] - self.frames[0][0]
        self.busy = _union((s, e) for s, e, *_ in self.ops)

    def _frame_of(self, t) -> Optional[int]:
        i = bisect.bisect_right(self._starts, t) - 1
        return i if i >= 0 and t < self.frames[i][1] else None

    # -- what readers use --------------------------------------------------
    def device_ms(self, names: Iterable[str]) -> Optional[float]:
        """Device time a frame of the ops launched inside any span of
        `names`; None where no such span holds an op."""
        names = frozenset(names)
        dur = [d for *_, owners, d in self.ops if owners & names]
        return sum(dur) / 1e3 / self.n_frames if dur else None

    def host_ms(self, names: Iterable[str]) -> Optional[float]:
        """Host time a frame inside any span of `names` (their union)."""
        names = frozenset(names)
        iv = [(s, e) for s, e, n in self.spans if n in names]
        if not iv:
            return None
        return sum(e - s for s, e in _union(iv)) / 1e3 / self.n_frames

    def syncs_per_frame(self) -> float:
        return len(self.syncs) / self.n_frames

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def window_s(self) -> float:
        return self.window_us / 1e6

    def innermost(self, t) -> str:
        """The innermost span open on the host at time t."""
        best = None
        for s, e, n in self.spans:
            if s <= t < e and (best is None or e - s < best[0]):
                best = (e - s, n)
        return best[1] if best else "between spans"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device ops by name that took most time, and the longest idle
        gaps inside the frames by the host span open when each began
        (seconds over the traced window)."""
        by_name = defaultdict(float)
        for *_, name, _, d in self.ops:
            by_name[kernel_family(name)] += d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        for f0, f1 in self.frames:
            inside = [(max(s, f0), min(e, f1)) for s, e in self.busy
                      if e > f0 and s < f1]
            t = f0
            for s, e in inside:
                if s > t:
                    gaps.append((s - t, t))
                t = max(t, e)
            if f1 > t:
                gaps.append((f1 - t, t))
        gaps.sort(reverse=True)
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.innermost(t), g / 1e6]
                              for g, t in gaps[:n]]}
