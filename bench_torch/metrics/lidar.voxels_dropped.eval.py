"""Occupied voxels a frame that `max_voxels` leaves out: each cloud's
count before the cap (the program's `voxels.raw`, over the traced frames)
less the cap where it exceeds it, summed over the clouds. 0 where every
voxel is kept. None where the program counts no such voxels."""

from bench_torch import program_spans


def read(run):
    values = program_spans.traced_values("voxels.raw")
    if not values:
        return None
    cap = run.config["lidar"]["max_voxels"]
    return sum(max(v - cap, 0) for v in values) / run.trace.n_frames
