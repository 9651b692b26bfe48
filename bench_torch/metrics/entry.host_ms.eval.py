"""Host ms a frame inside the harness's spans around the program's entry:
the copy-in (`to_device`) and the decode with the boxes' readback."""


def read(run):
    return run.trace.host_ms(["entry.copy_in", "entry.decode"])
