"""Tracing and timing helpers (counterpart of cmtcoop_tpu/utils/profiling.py).

`trace` records a `torch.profiler` trace of the host and the card and
exports it as a Chrome trace; `time_fn` times a function on the card with
CUDA events, reporting its first call (the kernels' build and warm-up, where
the JAX package reports its compile) apart; `StepTimer` keeps the train
loop's rolling seconds per step and the share spent waiting for data.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "runs/trace"):
    """`with trace(): step()` -> `logdir/trace.json` (chrome://tracing or
    Perfetto), CUDA activity included when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
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


class StepTimer:
    """Rolling sec/it + data-wait split for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.data_times = []
        self._t = time.time()

    def data_ready(self):
        now = time.time()
        self.data_times.append(now - self._t)
        self._t = now

    def step_done(self):
        now = time.time()
        self.times.append(now - self._t)
        self._t = now
        if len(self.times) > self.window:
            self.times.pop(0)
            self.data_times.pop(0)

    @property
    def sec_per_step(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def data_fraction(self) -> float:
        tot = sum(self.times) + sum(self.data_times)
        return sum(self.data_times) / max(tot, 1e-9)
