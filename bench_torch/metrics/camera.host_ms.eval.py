"""Host ms a frame inside the spans of
the camera branch (VoVNet and the image neck)."""

SPANS = ["image backbone", "image neck"]


def read(run):
    return run.trace.host_ms(SPANS)
