"""Reads torch.profiler's trace of a slice of frames: the device's busy
time, the device operations that took the most time, and the idle gaps
named by what the host was doing in them."""

from __future__ import annotations

import warnings

import numpy as np
import torch

# Clock cycles (about 1 ms on the H100) of the spin kernel that opens a
# profiled slice: the trace can lose the first device operations after it
# starts, so the spin goes first and is left out.
SPIN_CYCLES = 2_000_000
SPIN_NAME = "spin_kernel"
TOP = 10
NAME_CHARS = 160


def profile(run, *, host: bool):
    """torch.profiler over `run()` (device activity, and the host's with
    `host`), the slice opened by the spin kernel.  Returns (device
    events, host events), each a list of (name, start_us, end_us)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # Without a schedule the profiler warns that it keeps one cycle.
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            run()
            torch.cuda.synchronize()
    dev, cpu = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if SPIN_NAME not in e.name:
                dev.append(item)
        elif host:
            cpu.append(item)
    return dev, cpu


def busy(dev) -> tuple[float, float, list]:
    """(busy seconds, slice seconds, idle gaps [(start_us, end_us)]) of the
    device events: the union of their intervals, within the slice from the
    first start to the last end."""
    if not dev:
        return 0.0, 0.0, []
    spans = sorted((s, e) for _n, s, e in dev)
    total, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total / 1e6, (cur_e - spans[0][0]) / 1e6, gaps


def top_ops(dev) -> list:
    """[[name, seconds]] of the device operations with the most time."""
    by = {}
    for n, s, e in dev:
        by[n] = by.get(n, 0.0) + (e - s) / 1e6
    return [[n[:NAME_CHARS], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def named_gaps(gaps, cpu) -> list:
    """[[host op, seconds]] of the idle gaps, summed by the host operation
    that overlaps each gap the most (the shorter op on a tie; "(no host
    op)" where none does), the largest first."""
    if not gaps:
        return []
    by = {}
    names = [n for n, _s, _e in cpu]
    start = np.array([s for _n, s, _e in cpu], dtype=np.float64)
    end = np.array([e for _n, _s, e in cpu], dtype=np.float64)
    for g0, g1 in gaps:
        name = "(no host op)"
        if len(names):
            ov = np.minimum(end, g1) - np.maximum(start, g0)
            hit = np.nonzero(ov > 0)[0]
            if hit.size:
                order = np.lexsort((end[hit] - start[hit], -ov[hit]))
                name = names[hit[order[0]]]
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
    return [[n[:NAME_CHARS], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
