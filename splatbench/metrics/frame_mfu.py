"""frame_mfu: the frame's least time on the card (work.frame_least_ms, on
the last frame's inputs) over the frame's time in the profiled slice: its
device time from the first operation to the last over its frames.  The
slice runs without the timer, whose events slow the host-paced frame.  No
fusion can take it past 100%."""

from splatbench.metrics import work


def read(r):
    ms = r.slice_frame_ms()
    if not r.work or not ms:
        return None
    return 100.0 * work.frame_least_ms(r.work) / ms
