"""CUDA synchronize calls a frame inside the program's spans of
the LiDAR branch (pillarize, the pillar encoder with its maps, SECOND and its FPN)."""

from bench_torch import program_spans


def read(run):
    return program_spans.syncs(run, program_spans.LIDAR)
