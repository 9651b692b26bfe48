"""Occupied voxels a frame that the LiDAR branch keeps: each cloud's count
before `max_voxels` (the program's `voxels.raw`, over the traced frames),
at most the configuration's `max_voxels`, summed over the clouds. The
traffic fixes the voxels; the reading falls only where the cap leaves
some out, so higher is better. None where the program counts no such
voxels."""

from bench_torch import program_spans


def read(run):
    values = program_spans.traced_values("voxels.raw")
    if not values:
        return None
    cap = run.config["lidar"]["max_voxels"]
    return sum(min(v, cap) for v in values) / run.trace.n_frames
