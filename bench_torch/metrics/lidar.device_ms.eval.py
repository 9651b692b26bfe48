"""Device ms a frame of the ops launched inside the spans of
the LiDAR branch (pillarize, the pillar encoder with its maps, SECOND and its FPN)."""

SPANS = ["pillarize", "pillar encoder", "SECOND", "FPN"]


def read(run):
    return run.trace.device_ms(SPANS)
