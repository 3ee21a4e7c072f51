"""device_idle_pct: the share of the profiled slice (torch.profiler's
device trace over a fixed number of frames, from its first device
operation to its last) in which no kernel, copy or memset ran."""


def read(r):
    if not r.window_s or r.busy_s is None:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
