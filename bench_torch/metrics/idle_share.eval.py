"""The share of an untraced frame in which no operation ran on the
device, in %: 1 - (device busy time a traced frame) / (the untraced
window's time a frame). The traced frames give the busy time, which the
profiler does not stretch; their wall time it does, so the frame time is
the untraced window's, as `mfu.eval` takes it."""


def read(run):
    busy = run.trace.busy_s()
    if not busy or not run.frame_s:
        return None  # no device op in the trace: nothing to read
    return 100.0 * (1.0 - busy / run.trace.n_frames / run.frame_s)
