"""idle_host_paced_pct: the share of a profiled slice, drawn under the
host-only tracer, in which the device idled while the host was inside a
`frame` span and outside every `sync` span (hostprof.idle_split): idle
that the host's own work in `Renderer.draw` left, and not a wait for the
device.  The slice's length runs from its first device operation to its
last, the spans' GPU user annotations left out."""


def read(r):
    if r.host_idle is None or not r.host_slice_s:
        return None
    return 100.0 * r.host_idle["in_port_us"] / 1e6 / r.host_slice_s
