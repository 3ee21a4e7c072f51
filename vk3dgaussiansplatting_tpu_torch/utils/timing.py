"""Per-pass GPU timing with CUDA events.

The reference's `RECORD_GPU_TIMES` mode (Renderer.h:35-36, Renderer.cpp:
458-510) writes GPU timestamps around each logical pass.  `CudaPassTimer` is
the same on PyTorch's current stream: a pass wrapped in
`section(timer, name)` records an event before and after it, and nothing
waits for the device until `summary()`.  With `timer=None` a section costs
nothing, so the frame code carries the sections unconditionally.

Sections of the frame: keygen (expand inside it), sort, ranges, and then
either blend (K2, or the whole static-cap blend) or the temporal capped
passes: layout (the K1 chunk map, K5 compaction and the feature table),
blend (K3 with its transmittance), policy (validation and the caps and
threshold update, up to the branch read-back) and patch (the patch pass or
full fallback; empty on fast-path frames).  The distributed frame
(parallel/dist.py): keygen, bucket, exchange (the collectives, with the
copies through host memory where gloo serves a GPU), sort, ranges and blend
(K4, once per systolic phase).
"""

from __future__ import annotations

import contextlib
import statistics

import torch


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
