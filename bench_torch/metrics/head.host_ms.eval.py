"""Host ms a frame inside the spans of
the head (memory, RV position encodings, decoder, task heads)."""

SPANS = ["head memory", "rv pe", "decoder", "task heads"]


def read(run):
    return run.trace.host_ms(SPANS)
