"""CUDA synchronize calls a frame inside the program's spans of
the eval entry (`to_device`, the decode, the boxes)."""

from bench_torch import program_spans


def read(run):
    return program_spans.syncs(run, program_spans.ENTRY)
