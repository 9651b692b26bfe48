"""The frame's model operations (flops.py, from the configuration's widths
and each served frame's active voxels) over the untraced frame time at
the card's bf16 peak, in %."""


def read(run):
    if run.peak is None or not run.frame_s:
        return None
    return 100.0 * run.flops_per_frame / (run.frame_s
                                          * run.peak["bf16_ops_per_s"])
