"""Active BEV cells a frame that the pillar encoder's caps leave out:
each level's count before its cap (`pillars.l<k>`, over the traced
frames) less the cap where it exceeds it, summed over the levels and the
agents. 0 where every cell is kept."""

from bench_torch import program_spans


def read(run):
    counts = program_spans.pillar_counts(run)
    if not counts:
        return None
    return sum(max(v - cap, 0) for v, cap in counts) / run.trace.n_frames
