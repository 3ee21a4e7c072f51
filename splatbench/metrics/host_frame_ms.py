"""host_frame_ms: the host's ms a frame inside `Renderer.draw`, less the
blocking reads inside it: the `frame` spans of the host-only tracer less
the `sync` spans within them (hostprof.span_summary), over a closed loop
of 4 x trace_frames frames with no profiler running.  Where the device's
frame falls to it, the host paces the frame."""


def read(r):
    if not r.host_spans:
        return None
    return r.host_spans["host_frame_ms"]
