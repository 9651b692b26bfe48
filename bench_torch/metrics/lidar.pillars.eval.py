"""Active BEV cells a frame in the pillar encoder, each level at most its
cap (the configuration's `pillar_caps`, the last for deeper levels),
summed over the levels and the agents: the LiDAR branch's work kept. The
traffic fixes the cells; the reading falls only where a cap leaves some
out, so higher is better. The program counts each level's cells before
its cap (`pillars.l<k>`, over the traced frames)."""

from bench_torch import program_spans


def read(run):
    counts = program_spans.pillar_counts(run)
    if not counts:
        return None
    return sum(min(v, cap) for v, cap in counts) / run.trace.n_frames
