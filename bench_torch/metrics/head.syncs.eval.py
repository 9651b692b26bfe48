"""CUDA synchronize calls a frame inside the program's spans of
the head (memory, RV position encodings, decoder, task heads)."""

from bench_torch import program_spans


def read(run):
    return program_spans.syncs(run, program_spans.HEAD)
