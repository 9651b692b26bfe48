"""The share, in %, of the bytes the program's `to_device` copies from the
host to the card that it copies from pageable memory: its running totals
`h2d.pageable_bytes` over `h2d.bytes`, over every frame the run served.
A pageable copy is staged through a pinned buffer on the host thread; a
pinned pool reads 0."""

from bench_torch import program_spans


def read(run):
    prof = program_spans.recorder()
    if prof is None or not prof.total("h2d.bytes"):
        return None
    return 100.0 * prof.total("h2d.pageable_bytes") / prof.total("h2d.bytes")
