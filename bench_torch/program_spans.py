"""What the per-layer metrics of the program's own spans and counters
read (`cmtcoop_tpu_torch/utils/profiling.py`): the stage clock's ring of
untraced calls and its traced book, the counters' traced values, and per
span the host syncs and device ops of the traced frames.

The program is imported by the functions here, never when this module is
imported. Where the program has no recorder (a tree from before it), or
the trace holds none of a layer's spans, a reader finds nothing: None.
"""
from __future__ import annotations

import itertools
from typing import Iterable, List, Optional, Tuple

ENTRY = ("eval.to_device", "eval.decode", "eval.boxes")
CAMERA = ("image backbone", "image neck")
LIDAR = ("pillarize", "pillar encoder", "SECOND", "FPN")
HEAD = ("head memory", "rv pe", "decoder", "task heads")


def recorder():
    """The program's `utils.profiling` module where it records spans and
    counters, else None."""
    try:
        from cmtcoop_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "traced_values") else None


def clock_ms(run, names: Iterable[str]) -> Optional[float]:
    """Host ms a frame of the spans `names` on the stage clock, over the
    untraced window's frames: per name, the mean ms a call over the
    window's calls (a call inside another of `names` counting 0, so the
    names read their union) times its calls a traced frame, summed.

    The window's calls are the newest untraced ones before the profiler's
    warm-up frame (the one untraced frame the harness serves after the
    window), `calls a frame` x the window's frames of them: the host's
    speed drifts within a run, so a mean over fewer frames than the
    window's would not divide `frame_ms`. None where a name's calls a
    frame are not the same in every traced frame, or where its ring no
    longer holds the window and that frame (too many calls for the ring):
    a reading of part of the window would be a wrong one."""
    prof = recorder()
    if prof is None:
        return None
    names = tuple(names)
    frames = len(run.frame_times_s)
    total, seen = 0.0, False
    for name in names:
        calls = prof.traced_calls(name)
        k, rest = divmod(calls, run.trace.n_frames)
        if not calls:
            continue
        ms = prof.host_ms(name, outside=names, calls=k * frames, skip=k)
        if rest or ms is None:
            return None
        total += ms * k
        seen = True
    return total if seen else None


def traced_values(name: str) -> List[float]:
    """The program's counter `name` over the traced frames ([] if none)."""
    prof = recorder()
    return prof.traced_values(name) if prof is not None else []


def pillar_counts(run) -> List[Tuple[float, int]]:
    """Each traced count of active BEV cells before its level's cap
    (`pillars.l<k>`, one a level, an agent and a frame) beside that cap
    (the configuration's `pillar_caps`, the last for deeper levels)."""
    caps = run.config["lidar"]["pillar_caps"]
    out = []
    for k in itertools.count():
        values = traced_values(f"pillars.l{k}")
        if not values:
            return out
        out += [(v, caps[min(k, len(caps) - 1)]) for v in values]


def syncs(run, names: Iterable[str]) -> Optional[float]:
    """Host synchronize calls a frame inside any span of `names`; None
    where the trace holds no device op or none of the spans."""
    names = frozenset(names)
    tr = run.trace
    spans = [(s, e) for s, e, n in tr.spans if n in names]
    if not tr.ops or not spans:
        return None
    return sum(any(s <= t < e for s, e in spans)
               for t in tr.syncs) / tr.n_frames


def launches(run, names: Iterable[str]) -> Optional[float]:
    """Device ops (kernels, copies, memsets) a frame launched inside any
    span of `names`; None where there is none."""
    names = frozenset(names)
    n = sum(1 for *_, owners, _ in run.trace.ops if owners & names)
    return n / run.trace.n_frames if n else None
