"""Host ms a frame of the program's spans of
the eval entry (`to_device`, the decode, the boxes)
on its stage clock, from the untraced frames: per span, the mean ms a call
over its ring times its calls a traced frame (program_spans.py
`clock_ms`)."""

from bench_torch import program_spans


def read(run):
    return program_spans.clock_ms(run, program_spans.ENTRY)
