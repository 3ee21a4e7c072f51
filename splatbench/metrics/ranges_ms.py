"""ranges_ms: ms a frame in the pipeline's `ranges` section, summed over the
traced window and divided by its frames."""


def read(r):
    return r.per_frame_ms("ranges")
