"""CUDA synchronize calls a frame, counted in the trace's runtime events
(`cudaDeviceSynchronize`, `cudaStreamSynchronize`, `cudaEventSynchronize`)
inside the frames."""


def read(run):
    return run.trace.syncs_per_frame()
