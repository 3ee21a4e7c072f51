"""Per-layer metrics: one reader a metric, `metrics/<name>.py`, found by the
metric's name in BENCHMARK.json.  A reader's `read(r: Readings)` returns
the metric's value, or None where its run gives it nothing to read; the
harness then leaves the metric out of the result line.  `work.py` holds
the work counts the roofline shares and `frame_mfu` divide by."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Readings(NamedTuple):
    """What a traced run read.

    frames:      frames drawn in the traced window
    sections:    ms summed over the window of each pass the pipeline marks
                 with `section()` (utils.timing.CudaPassTimer): CUDA events
                 on the stream around the pass, so a pass's time includes
                 any wait for the host to enqueue it
    path_counts: the capped blend's branch counts over the window
                 (ops/capped.PATH_COUNTS: fast, patch, full)
    live_mean:   live sort elements a frame, over the window (the frames'
                 `num_elements`)
    work:        counts on the last frame's inputs, from the reference:
                 gaussians, visible, pixels, pairs (P), eligible
    slice_frames: frames drawn in the profiled slice, which runs without
                 the timer (its events cost the host time)
    busy_s, window_s: device time with an operation running, and the
                 length from its first operation to its last, of that slice
    host_spans:  hostprof.span_summary of the host-only tracer
                 (CudaPassTimer(device_events=False)) over a closed loop with
                 no profiler running: host ms a frame by span, host_frame_ms
    host_idle:   hostprof.idle_split (us) of a profiled slice of
                 `slice_frames` frames drawn under the host-only tracer:
                 the device's idle time inside a `frame` span outside every
                 `sync`, inside a `sync`, and outside the port
    host_slice_s: that slice's length, from its first device operation to
                 its last
    """

    frames: int
    sections: dict
    path_counts: dict
    live_mean: float | None
    work: dict | None
    slice_frames: int
    busy_s: float | None
    window_s: float | None
    host_spans: dict | None = None
    host_idle: dict | None = None
    host_slice_s: float | None = None

    def slice_frame_ms(self) -> float | None:
        """The profiled slice's device time from its first operation to its
        last, over its frames; None without a slice."""
        if not self.window_s or not self.slice_frames:
            return None
        return self.window_s * 1e3 / self.slice_frames

    def per_frame_ms(self, *names: str) -> float | None:
        """The sections' summed ms over the frames; None if one is absent."""
        if not self.frames or not all(n in self.sections for n in names):
            return None
        return sum(self.sections[n] for n in names) / self.frames


def load(name: str, directory: Path = HERE):
    """The `read` function of `directory`/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{name}",
                                                  directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
