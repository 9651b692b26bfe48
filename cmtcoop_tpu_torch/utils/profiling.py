"""Tracing and timing (counterpart of cmtcoop_tpu/utils/profiling.py).

The program's spans and counters, always on:

- `span(name)` marks a stage, as a context manager or a decorator. Every
  call is timed on the host clock (`time.perf_counter_ns`): calls made
  while no profiler records go to a ring of the name's last `RING`
  durations, calls made while `torch.profiler` records go to a traced
  book that counts them. While a profiler records, the span also enters
  `torch.profiler.record_function(name)`, so it sits in the profiler's
  trace beside the device ops it launched; otherwise it enters none. A
  per-thread stack gives each call the names of the spans it is inside.
- `count(name, value)` adds to a counter. A host integer is added to a
  running total on every call; a tensor (a device scalar) is only kept,
  and only while a profiler records, so a counter neither synchronises
  nor launches inside a frame. Values from calls made while a profiler
  records go to the traced book. While a CUDA graph captures
  (`models/graphs.py`), counts go to the capture's tap instead, a tensor
  as a copy the graph rewrites on each replay, and the graph's owner
  counts them after each replay.

The traced book holds the latest profiling session: the first span or
count that finds a profiler recording after one had found none empties
it. Readers: `host_ms`, `traced_calls`, `traced_values`, `total`;
`reset` empties everything.

`trace` records a `torch.profiler` trace of the host and the card and
exports it as a Chrome trace, the program's spans in it; `time_fn` times
a function on the card with CUDA events, reporting its first call (the
kernels' build and warm-up, where the JAX package reports its compile)
apart.

Importing this module imports no torch, so numpy-only modules may span.
"""
from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, Optional

# untraced calls kept a span name: at 4 calls a frame, 1024 frames, a
# 30-s run of frames of 30 ms or more; a reader asking for more calls than
# the ring holds gets None
RING = 4096
_PROFILER = "torch.autograd.profiler"  # present once torch is imported


class _Span:
    """The span of one name in one recorder; reentrant, so one object
    serves every call of the name (its per-call state is on the
    recorder's per-thread stack)."""

    __slots__ = ("name", "rec", "ring")

    def __init__(self, name: str, rec: "Recorder"):
        self.name, self.rec = name, rec
        self.ring = rec.rings[name]

    def __enter__(self):
        rec = self.rec
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._local.stack = []
        path = stack[-1][0] + (self.name,) if stack else (self.name,)
        # `Recorder._recording` inlined: this runs on every call
        prof = sys.modules.get(_PROFILER)
        if prof is not None and prof._is_profiler_enabled:
            if not rec._in_session:
                rec._new_session()
            rf = prof.record_function(self.name)
            rf.__enter__()
            stack.append((path, rec.clock(), rf))
        else:
            rec._in_session = False
            stack.append((path, rec.clock()))
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        t1 = rec.clock()
        entry = rec._local.stack.pop()
        if len(entry) == 2:
            self.ring.append((t1 - entry[1], entry[0]))
        else:
            entry[2].__exit__(None, None, None)
            rec.traced[self.name] += 1
        return False

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


class Recorder:
    """Spans and counters (module docstring). `ring` untraced calls are
    kept a name; `clock` returns integer nanoseconds."""

    def __init__(self, ring: int = RING,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.ring, self.clock = ring, clock
        self._local = threading.local()
        self._spans: Dict[str, _Span] = {}
        # the open captures' taps, innermost last: (name, value) lists
        self.taps: List[list] = []
        self.rings: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.ring))
        self.reset()

    def reset(self) -> None:
        for ring in self.rings.values():
            ring.clear()
        self.totals = defaultdict(int)
        self._new_session()
        self._in_session = False

    def _new_session(self) -> None:
        self.traced = defaultdict(int)
        self.traced_counts = defaultdict(list)
        self._in_session = True

    def recording(self) -> bool:
        """Whether a profiler records (a tensor counted now is kept)."""
        return self._recording()

    def _recording(self) -> bool:
        prof = sys.modules.get(_PROFILER)
        if prof is not None and prof._is_profiler_enabled:
            if not self._in_session:
                self._new_session()
            return True
        self._in_session = False
        return False

    def span(self, name: str) -> _Span:
        try:
            return self._spans[name]
        except KeyError:
            return self._spans.setdefault(name, _Span(name, self))

    def count(self, name: str, value) -> None:
        if self.taps:
            self.taps[-1].append((name, value.detach().clone()
                                  if hasattr(value, "detach") else
                                  int(value)))
            return
        if hasattr(value, "detach"):
            if self._recording():
                self.traced_counts[name].append(value.detach())
            return
        value = int(value)
        self.totals[name] += value
        if self._recording():
            self.traced_counts[name].append(value)

    # -- readers -----------------------------------------------------------
    def host_ms(self, name: str, outside: Iterable[str] = (),
                calls: Optional[int] = None, skip: int = 0
                ) -> Optional[float]:
        """Mean host ms a call of `name` over its ring (the untraced
        calls), or over the `calls` newest of them before the newest
        `skip`; None where there are none, or where the ring holds fewer
        than `calls + skip` (the calls asked for have left it). A call
        made inside a span of `outside` counts as 0 ms: its time is that
        span's, so summing `host_ms(n, outside=names)` over `names` takes
        their union."""
        ring = list(self.rings.get(name, ()))
        if calls is not None and len(ring) < calls + skip:
            return None
        ring = ring[:max(len(ring) - skip, 0)]
        if calls is not None:
            ring = ring[len(ring) - calls:]
        if not ring:
            return None
        outside = frozenset(outside)
        ns = sum(d for d, path in ring if outside.isdisjoint(path[:-1]))
        return ns / len(ring) / 1e6

    def traced_calls(self, name: str) -> int:
        """Calls of span `name` while a profiler recorded."""
        return self.traced.get(name, 0)

    def traced_values(self, name: str) -> List[float]:
        """The values counted under `name` while a profiler recorded, as
        Python numbers (a tensor is read on the host here, one number an
        element)."""
        out = []
        for v in self.traced_counts.get(name, ()):
            if hasattr(v, "reshape"):
                out.extend(v.reshape(-1).tolist())
            else:
                out.append(v)
        return out

    def total(self, name: str) -> int:
        """The running total of the host integers counted under `name`."""
        return self.totals.get(name, 0)


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
recording = RECORDER.recording
host_ms = RECORDER.host_ms
traced_calls = RECORDER.traced_calls
traced_values = RECORDER.traced_values
total = RECORDER.total
reset = RECORDER.reset


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """`with trace(): step()` -> `logdir/trace.json` (chrome://tracing or
    Perfetto), CUDA activity included when a card is present."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    import torch
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def materialize(out) -> float:
    """Wait for the card, then read one scalar derived from `out` (its first
    tensor) on the host."""
    import torch
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.float().sum()) if t is not None else 0.0


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            name: Optional[str] = None) -> Dict[str, float]:
    """Seconds per call of `fn(*args)` on the card: CUDA events around
    `iters` calls after a synchronize and `warmup` calls. The first call's
    host seconds (the kernels' build and warm-up) are `first_call_s`. Needs
    a card: a measurement without one would be of the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn times on the card; no CUDA device")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    materialize(fn(*args))
    first_call_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    per_iter = start.elapsed_time(end) / 1e3 / iters
    out = {"first_call_s": first_call_s, "per_iter_s": per_iter,
           "fps": 1.0 / per_iter}
    if name:
        print(f"{name}: {per_iter * 1e3:.1f} ms ({out['fps']:.2f}/s, "
              f"first call {first_call_s:.1f}s)")
    return out
