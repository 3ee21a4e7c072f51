"""project_ms: K7's device ms a frame (keygen_kernel.project_gaussians,
csrc/keygen.cu): the device operations launched inside the port's
`project` spans, joined by launch over the launch slice (splatbench/
launches.py), summed and divided by its frames.  No CUDA event pair is
added to the window for it (`project` is HOST_ONLY)."""


def read(r):
    j = getattr(r, "launches", None)
    if not j or not j["frames"] or "project" not in j["span_ns"]:
        return None
    return j["span_ns"]["project"] / 1e6 / j["frames"]
