"""keygen_roofline_pct: keygen's least time (work.keygen_least_ms: the
table rows it needs read once, the window's mean live elements and the
frame data of the gaussians in view written once) over keygen_ms."""

from splatbench.metrics import work


def read(r):
    ms = r.per_frame_ms("keygen")
    if not ms or not r.work or r.live_mean is None:
        return None
    return 100.0 * work.keygen_least_ms(r.work, r.live_mean) / ms
