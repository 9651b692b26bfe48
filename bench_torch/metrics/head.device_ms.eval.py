"""Device ms a frame of the ops launched inside the spans of
the head (memory, RV position encodings, decoder, task heads)."""

SPANS = ["head memory", "rv pe", "decoder", "task heads"]


def read(run):
    return run.trace.device_ms(SPANS)
