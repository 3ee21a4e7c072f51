"""bitonic_shared_ms: ms a frame in the bitonic tier's shared-memory passes
(the `bitonic_shared` sections inside `sort`: the first block sort and
each k's merge below the block), summed over the traced window and divided
by its frames.  None where the run has no such section (the radix sort)."""


def read(r):
    return r.per_frame_ms("bitonic_shared")
