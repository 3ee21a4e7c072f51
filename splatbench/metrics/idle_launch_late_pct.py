"""idle_launch_late_pct: the share of the launch slice (splatbench/
launches.py: device activity alone, drawn under the host-only tracer with
its spans on the trace's clock), from its first device operation to its
last, in which the device idled waiting for a launch the host had not yet
made: each idle gap's part up to the end of the call that launched the
operation ending it.  At most the slice's idle share; the rest of the
idle is the stream's own."""


def read(r):
    j = getattr(r, "launches", None)
    if not j or not j["window_ns"]:
        return None
    return 100.0 * sum(j["late_ns"].values()) / j["window_ns"]
