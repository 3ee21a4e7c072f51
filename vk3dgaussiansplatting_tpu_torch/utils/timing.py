"""Per-pass GPU timing with CUDA events, and the reference's benchmark
protocol (port of `vk3dgaussiansplatting_tpu.utils.timing`).

The reference's `RECORD_GPU_TIMES` mode (Renderer.h:35-36, Renderer.cpp:
458-510) writes GPU timestamps around each logical pass.  `CudaPassTimer` is
the same on PyTorch's current stream: a pass wrapped in
`section(timer, name)` records an event before and after it, and nothing
waits for the device until `summary()`.  With `timer=None` a section costs
nothing, so the frame code carries the sections unconditionally.

Sections of the frame: keygen (expand inside it), sort, ranges, and then
either blend (K2, or the whole static-cap blend) or the temporal capped
passes: layout (the tiles' counts and slabs, and K5's id copy),
blend (K3 with its transmittance), policy (validation and the caps and
threshold update, up to the branch read-back) and patch (the patch pass or
full fallback; empty on fast-path frames).  The distributed frame
(parallel/dist.py): keygen, bucket, exchange (the collectives, with the
copies through host memory where gloo serves a GPU), sort, ranges and blend
(K4, once per systolic phase).

`RunningAverage`, `time_fn` and `time_fn_avg_protocol` are the reference's
`RECORD_GPU_TIMES` protocol (1000 warm-up frames, then a 1000-frame running
mean, Renderer.cpp:477-487): on CUDA each call is timed with CUDA events
around it on the current stream (the device's time, not the host's), on the
CPU with `time.perf_counter`.  Both return seconds, as the JAX functions do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable

import torch

# Reference protocol constants (Renderer.h:142-143).
WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG = 1000
NUM_AVG_FRAMES = 1000


class CudaPassTimer:
    """Collects (start, end) CUDA event pairs per pass name."""

    def __init__(self) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError("CudaPassTimer needs a CUDA device")
        self._events: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events.setdefault(name, []).append((start, end))

    def summary(self) -> dict[str, float]:
        """Synchronize and return each pass's median duration in ms."""
        torch.cuda.synchronize()
        return {
            name: statistics.median(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in self._events.items()
        }

    def totals(self) -> dict[str, float]:
        """Synchronize and return each pass's summed duration in ms (for
        passes entered several times a frame, as in the distributed frame)."""
        torch.cuda.synchronize()
        return {
            name: sum(s.elapsed_time(e) for s, e in pairs)
            for name, pairs in self._events.items()
        }


def section(timer: CudaPassTimer | None, name: str):
    """`timer.section(name)`, or a no-op context when timer is None."""
    return contextlib.nullcontext() if timer is None else timer.section(name)


@dataclasses.dataclass
class RunningAverage:
    """The reference's running-mean update (Renderer.cpp:477-487)."""

    warmup_frames: int = WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG
    avg_frames: int = NUM_AVG_FRAMES
    _seen: int = 0
    _count: int = 0
    _mean: float = 0.0

    def add(self, value: float) -> None:
        self._seen += 1
        if self._seen <= self.warmup_frames:
            return
        if self._count < self.avg_frames:
            self._count += 1
            self._mean += (value - self._mean) / self._count

    @property
    def done(self) -> bool:
        return self._count >= self.avg_frames

    @property
    def mean(self) -> float:
        return self._mean


def _timer(device):
    """A function timing one call of `fn` in seconds on `device`."""
    device = torch.device(device)
    if device.type == "cpu":
        def run_cpu(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return run_cpu
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")

    def run_cuda(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return run_cuda


def time_fn(fn: Callable[[], object], *, warmup: int = 3, iters: int = 20,
            device="cuda") -> float:
    """Median seconds of `fn` over `iters` calls after `warmup` calls: CUDA
    events on a CUDA device, `perf_counter` on the CPU."""
    run = _timer(device)
    for _ in range(warmup):
        run(fn)
    return statistics.median(run(fn) for _ in range(iters))


def time_fn_avg_protocol(fn: Callable[[], object], *,
                         warmup: int = WAIT_ELAPSED_WARMUP_FRAMES_FOR_AVG,
                         avg: int = NUM_AVG_FRAMES, device="cuda") -> float:
    """The reference protocol exactly: `warmup` frames, then the `avg`-frame
    running mean, in seconds.  Expensive: for headline numbers only."""
    run = _timer(device)
    acc = RunningAverage(warmup_frames=warmup, avg_frames=avg)
    while not acc.done:
        acc.add(run(fn))
    return acc.mean
