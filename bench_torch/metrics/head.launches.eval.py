"""Device ops (kernels, copies, memsets) a frame launched inside the
program's spans of
the head (memory, RV position encodings, decoder, task heads)."""

from bench_torch import program_spans


def read(run):
    return program_spans.launches(run, program_spans.HEAD)
