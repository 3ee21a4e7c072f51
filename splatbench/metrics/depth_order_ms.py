"""depth_order_ms: ms a frame in the radix path's depth order of the
gaussians (the `depth_order` section inside `keygen`:
radix_kernel.depth_order's prep, four scatters and scan), summed over the
traced window and divided by its frames.  None where the run has no such
section (the bitonic tier keeps the index order)."""


def read(r):
    return r.per_frame_ms("depth_order")
