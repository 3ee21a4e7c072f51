"""The port's tracing: CUDA events around every pass or a host span for
it, counters, and the frame's blocking reads.

The reference's `RECORD_GPU_TIMES` mode (Renderer.h:35-36, Renderer.cpp:
458-510) writes GPU timestamps around each logical pass.  `CudaPassTimer` is
the same on PyTorch's current stream: a pass wrapped in
`section(timer, name)` records an event before and after it, and nothing
waits for the device until `summary()`; `frame`, `quantize`, `sync` and
`project` get none (`HOST_ONLY`).  `CudaPassTimer(device_events=False)`, the
host-only tracer, needs no CUDA device and records a host span for every
section instead: `time.perf_counter_ns()` at its start and end, its
frame, its parent.  Either way a section is a
`torch.profiler.record_function("vk3d/<name>")`, so under torch.profiler
the pass is a CPU event on the device trace's clock; the host-only tracer
with `profiler_ranges=False` opens none, and its spans go onto that clock
by `ClockMap` instead (Kineto stamps host events, and the device events it
converts, in CLOCK_REALTIME, `time.time_ns()`; `perf_counter_ns` is
CLOCK_MONOTONIC).  With `timer=None` a section is a `nullcontext`, so the
frame code carries the sections unconditionally.

Spans of a frame: `frame` (Renderer.draw, and the distributed frame) is the
root; under it keygen (project, K7; depth_order on the radix path;
expand, K1), sort, ranges, and then either blend (K2, or the whole
static-cap blend) and quantize, or the temporal capped passes: layout
(the tiles' counts and slabs, and K5's id copy), blend (K3 with its
transmittance), policy (validation and the caps and threshold update, up
to the branch read-back) and patch (the patch pass or full fallback;
empty on fast-path frames), then quantize.  The distributed
frame (parallel/dist.py): keygen, bucket, exchange (the collectives, with
the copies through host memory where gloo serves a GPU), sort, ranges and
blend (K4, once per systolic phase).

`read_back(timer, tensor)` is the frame paths' one way to read a device
value on the host: a `sync` span around the wait, so the number of `sync`
spans is the frame's host synchronisations, and a span's self time (its
duration less its children's) is its host time outside them.  `count`
counts events that are not spans (the chained plan's steady switch,
declined switch and revert).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import NamedTuple

import torch

FRAME = "frame"  # the root span of one frame
SYNC = "sync"  # a blocking read of a device value (`read_back`)
PROFILER_PREFIX = "vk3d/"  # the sections' torch.profiler event names
# Sections that get no CUDA events: the frame's device time is the
# caller's frame time, no metric reads quantize's, a sync sits inside a
# pass, and project's (K7's) device time is read from the device trace by
# launch: each kernel put down to the span its launch call ran in.  Each
# added event pair, like the host spans, moved a section of a benchmark's
# traced window by 2-5% on an H100.
HOST_ONLY = frozenset({FRAME, "quantize", SYNC, "project"})


class Span(NamedTuple):
    """One section's host span: `perf_counter_ns` at its start and end,
    and the time its child spans cover.  `frame` is the index of the
    enclosing `frame` span in the timer (None outside one); `parent` the
    enclosing span's name (None at the root)."""

    name: str
    frame: int | None
    parent: str | None
    start_ns: int
    end_ns: int
    child_ns: int

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


class ClockMap(NamedTuple):
    """Span times (`perf_counter_ns`) onto torch.profiler's host clock
    (`time_ns`): `offset_ns` is added, the mean of the offsets read as a
    profiled slice opens and as it closes (`clock_offset`); `drift_ns` the
    second less the first; `error_ns` the wider bracket's half-width plus
    half the drift."""

    offset_ns: int
    error_ns: int
    drift_ns: int

    @classmethod
    def of(cls, opened: tuple[int, int], closed: tuple[int, int]) -> "ClockMap":
        drift = closed[0] - opened[0]
        return cls((opened[0] + closed[0]) // 2, max(opened[1], closed[1]) + abs(drift) // 2,
                   drift)

    def map(self, perf_ns: int) -> int:
        return perf_ns + self.offset_ns


def clock_offset(tries: int = 32) -> tuple[int, int]:
    """(`time_ns()` less `perf_counter_ns()`, its error) in ns, from the
    tightest of `tries` (perf_counter_ns, time_ns, perf_counter_ns)
    brackets: the offset to the bracket's middle, the error its
    half-width."""
    best = None
    for _ in range(tries):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[1] - best[0]:
            best = (p0, p1, wall)
    p0, p1, wall = best
    return wall - (p0 + p1) // 2, (p1 - p0 + 1) // 2


class CudaPassTimer:
    """Per section, a (start, end) CUDA event pair (`device_events`, but
    for `HOST_ONLY`), or a host span (`device_events=False`); and the
    `count` counters.  The two modes do not mix: a span's host work moves
    the event times around it.  A section opens a torch.profiler range
    while a profiler runs, unless `profiler_ranges` is False (the
    host-only tracer's spans then reach the trace by `ClockMap`)."""

    def __init__(self, device_events: bool = True, profiler_ranges: bool = True) -> None:
        if device_events and not torch.cuda.is_available():
            raise RuntimeError("CudaPassTimer needs a CUDA device (device_events=False does not)")
        self.device_events = device_events
        self.profiler_ranges = profiler_ranges
        self._events: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self._spans: list[Span] = []
        self._counts: dict[str, int] = {}
        self._open: list[list] = []  # [name, start_ns, child_ns] of the open spans
        self._frames = 0  # root `frame` spans opened
        self._frame: int | None = None  # the open frame's index

    @contextlib.contextmanager
    def section(self, name: str):
        # record_function costs ~10 us even with no profiler to record it.
        with (torch.profiler.record_function(PROFILER_PREFIX + name)
              if self.profiler_ranges and torch._C._autograd._profiler_enabled()
              else contextlib.nullcontext()):
            if not self.device_events:
                with self._span(name):
                    yield
            elif name in HOST_ONLY:
                yield
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events.setdefault(name, []).append((start, end))

    @contextlib.contextmanager
    def _span(self, name: str):
        parent = self._open[-1][0] if self._open else None
        if name == FRAME and parent is None:
            self._frame = self._frames
            self._frames += 1
        frame = self._frame
        entry = [name, time.perf_counter_ns(), 0]
        self._open.append(entry)
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            self._open.pop()
            if not self._open:
                self._frame = None
        if self._open:
            self._open[-1][2] += t1 - entry[1]
        self._spans.append(Span(name, frame, parent, entry[1], t1, entry[2]))
        self._counts[name] = self._counts.get(name, 0) + 1

    def count(self, name: str) -> None:
        self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> dict[str, float]:
        """Synchronize and return each pass's median duration in ms on the
        device (CUDA events)."""
        torch.cuda.synchronize()
        return {
            name: statistics.median(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in self._events.items()
        }

    def totals(self) -> dict[str, float]:
        """Synchronize and return each pass's summed duration in ms on the
        device (CUDA events; for passes entered several times a frame, as in
        the distributed frame)."""
        torch.cuda.synchronize()
        return {
            name: sum(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in self._events.items()
        }

    def counts(self) -> dict[str, int]:
        """The `count` counters and, with `device_events=False`, the spans
        by name (`frame`: frames, `sync`: host synchronisations)."""
        return dict(self._counts)

    def spans(self) -> list[Span]:
        """Every closed span, in the order they closed
        (`device_events=False`)."""
        return list(self._spans)


def section(timer: CudaPassTimer | None, name: str):
    """`timer.section(name)`, or a no-op context when timer is None."""
    return contextlib.nullcontext() if timer is None else timer.section(name)


def count(timer: CudaPassTimer | None, name: str) -> None:
    """`timer.count(name)`; nothing when timer is None."""
    if timer is not None:
        timer.count(name)


def read_back(timer: CudaPassTimer | None, value):
    """`value.tolist()` inside a `sync` section: a device tensor's value on
    the host (a Python scalar for a 0-d tensor), or a pending host copy's
    (`pipeline._PendingFlag`).  The frame paths read the device only
    through it, so the `sync` spans count their host synchronisations."""
    with section(timer, SYNC):
        return value.tolist()
