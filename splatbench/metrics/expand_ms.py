"""expand_ms: ms a frame in K1, the expansion that writes the sort
elements (the `expand` section inside `keygen`:
expand_kernel.expand_elements), summed over the traced window and divided
by its frames."""


def read(r):
    return r.per_frame_ms("expand")
