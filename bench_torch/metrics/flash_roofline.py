"""The share of its roofline that the decoder's eval cross-attention (kernel 3's function; work/flash.py) reach, in %: the least time the
card could take for each call's logical work (peaks.py `bound_s`), summed
over the traced frames, over the device time of every op launched inside
those calls."""

from bench_torch.peaks import bound_s

WORK = "flash"


def read(run):
    calls = run.work.get(WORK)
    if run.peak is None or not calls:
        return None
    device_ms = run.trace.device_ms(["work." + WORK])
    if not device_ms:
        return None
    bound = sum(bound_s(ops, nbytes, run.peak) for ops, nbytes in calls)
    return 100.0 * bound / (device_ms * run.trace.n_frames / 1e3)
