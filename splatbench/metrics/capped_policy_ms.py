"""capped_policy_ms: ms a frame in the capped blend's own passes around K3,
the sections `layout` (counts, slabs, K5's ids), `policy` (validation,
the caps and thresholds, the branch's read-back) and `patch` (the patch
pass or the full fallback), summed over the traced window and divided by
its frames.  Nothing to read on an uncapped frame."""


def read(r):
    return r.per_frame_ms("layout", "policy", "patch")
