"""The device memory that the program's CUDA graphs reserve for their
private pools (`graph.pool_bytes`, counted each frame: the graphs'
intermediates, which `peak_mem_gib` does not count once no tensor holds
them), in GiB, the most over the traced frames. None where the program
counts no such bytes."""

from bench_torch import program_spans


def read(run):
    values = program_spans.traced_values("graph.pool_bytes")
    if not values:
        return None
    return max(values) / 2 ** 30
