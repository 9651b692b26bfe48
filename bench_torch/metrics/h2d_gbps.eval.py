"""The host-to-device copy's rate in GB/s: the bytes the program's
`to_device` counts (`h2d.bytes`) over the traced frames, over the device
time of the ops launched inside its span `eval.to_device`."""

from bench_torch import program_spans


def read(run):
    nbytes = sum(program_spans.traced_values("h2d.bytes"))
    ms = run.trace.device_ms(["eval.to_device"])
    if not nbytes or not ms:
        return None
    return nbytes / run.trace.n_frames / (ms * 1e-3) / 1e9
