"""The share of the frame's graphable segments (the LiDAR branch's and the
head's, `models/graphs.py` in the program) that a CUDA graph replay
served, in %, over the traced frames: the program counts each frame's
segments as `graph.replayed` or `graph.eager` (run on the host: not
graphable, a new key's first frame or its capture). None where the
program counts neither."""

from bench_torch import program_spans


def read(run):
    replayed = sum(program_spans.traced_values("graph.replayed"))
    eager = sum(program_spans.traced_values("graph.eager"))
    if not replayed + eager:
        return None
    return 100.0 * replayed / (replayed + eager)
