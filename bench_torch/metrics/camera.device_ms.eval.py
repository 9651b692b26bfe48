"""Device ms a frame of the ops launched inside the spans of
the camera branch (VoVNet and the image neck)."""

SPANS = ["image backbone", "image neck"]


def read(run):
    return run.trace.device_ms(SPANS)
