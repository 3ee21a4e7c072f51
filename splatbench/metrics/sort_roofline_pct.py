"""sort_roofline_pct: the sort's least time (work.sort_least_ms: the
window's mean live elements read once and written once; slots past the
live count are not the sort's work) over sort_ms."""

from splatbench.metrics import work


def read(r):
    ms = r.per_frame_ms("sort")
    if not ms or r.live_mean is None:
        return None
    return 100.0 * work.sort_least_ms(r.live_mean) / ms
