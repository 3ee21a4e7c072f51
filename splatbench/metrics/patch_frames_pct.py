"""patch_frames_pct: the share of the capped blend's frames over the traced
window that took the patch pass or the full fallback (the port's counter
ops/capped.PATH_COUNTS, read as a difference over the window).  Nothing to
read where no capped frame ran."""


def read(r):
    total = sum(r.path_counts.values())
    if not total:
        return None
    return 100.0 * (r.path_counts.get("patch", 0) + r.path_counts.get("full", 0)) / total
