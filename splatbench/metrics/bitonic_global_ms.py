"""bitonic_global_ms: ms a frame in the bitonic tier's fused global passes
(the `bitonic_global` sections inside `sort`), summed over the traced
window and divided by its frames.  None where the run has no such
section."""


def read(r):
    return r.per_frame_ms("bitonic_global")
