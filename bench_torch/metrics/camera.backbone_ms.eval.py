"""Device ms a frame of the ops launched inside the image backbone's span
(VoVNet or ResNet, without the neck)."""

SPANS = ["image backbone"]


def read(run):
    return run.trace.device_ms(SPANS)
