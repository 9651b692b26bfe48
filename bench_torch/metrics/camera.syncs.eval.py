"""CUDA synchronize calls a frame inside the program's spans of
the camera branch (VoVNet and the image neck)."""

from bench_torch import program_spans


def read(run):
    return program_spans.syncs(run, program_spans.CAMERA)
