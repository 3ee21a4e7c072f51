"""blend_roofline_pct: the blend's least time (work.blend_least_ms: its
operations over P, or its image written once) over blend_ms.  In a capped
frame the section is K3's; P, not K3's batch-granular pairs, is the work."""

from splatbench.metrics import work


def read(r):
    ms = r.per_frame_ms("blend")
    if not ms or not r.work:
        return None
    return 100.0 * work.blend_least_ms(r.work) / ms
