"""Debug and observability utilities — port of
`vk3dgaussiansplatting_tpu.utils.debug` (the reference's debug facilities,
SURVEY.md §5), on PyTorch's own tools:

  * `memory_snapshot` / `write_memory_dump`: the VMA memory dump
    (`generateMemoryDump` -> VmaDump.json on hotkey T, Renderer.cpp:517-529).
  * `nan_guard`: the closest numerical analogue of the validation layers.
  * `profiler_trace`: the GPU timestamp queries (QueryPoolArray), as a
    torch.profiler trace.

Each function's docstring says how it differs from the JAX one.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import tempfile

import torch


def _live_tensors():
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # tracked module proxies answer with a deprecation warning.
        if issubclass(type(obj), torch.Tensor):
            yield obj


def memory_snapshot(limit: int = 200) -> dict:
    """Live tensors and the CUDA caching allocator's state (the VmaDump.json
    equivalent).

    JAX lists `jax.live_arrays()` and the device's `memory_stats()`.  Here
    "arrays" are the first `limit` tensors the garbage collector tracks, on
    any device (views counted at their own size; `total_tracked_bytes` sums
    those listed, as JAX's does); with CUDA, "device_stats" is
    `torch.cuda.memory_stats()` and "segments" summarises each allocator
    segment of `torch.cuda.memory._snapshot()` (size, bytes allocated,
    stream, pool) without its blocks' stack traces.  Without CUDA both are
    empty."""
    arrays = []
    total = 0
    for i, t in enumerate(_live_tensors()):
        if i >= limit:
            break
        nbytes = t.numel() * t.element_size()
        total += nbytes
        arrays.append({"shape": list(t.shape), "dtype": str(t.dtype), "nbytes": int(nbytes),
                       "device": str(t.device)})
    stats, segments = {}, []
    if torch.cuda.is_available():
        stats = {k: int(v) for k, v in torch.cuda.memory_stats().items()}
        segments = [
            {k: seg.get(k) for k in ("device", "total_size", "allocated_size", "stream",
                                     "segment_type")}
            for seg in torch.cuda.memory._snapshot()["segments"]
        ]
    return {"total_tracked_bytes": int(total), "arrays": arrays, "device_stats": stats,
            "segments": segments}


def write_memory_dump(path: str = "MemDump.json") -> str:
    """Write `memory_snapshot()` as JSON (the reference writes VmaDump.json);
    the same file name as the JAX function's."""
    with open(path, "w") as f:
        json.dump(memory_snapshot(), f, indent=1)
    return path


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


class _NanGuard(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise FloatingPointError where a torch operation inside the scope
    returns a NaN.

    JAX's version sets `jax_debug_nans`, which re-runs the failing primitive
    un-jitted.  This one checks the output of every torch function called
    from Python (a TorchFunctionMode), reading each back to the host (slow:
    debug only); the CUDA kernels, launched through ctypes, are not checked
    themselves, only the torch operations that use their results."""
    with _NanGuard():
        yield


@contextlib.contextmanager
def profiler_trace(logdir: str | None = None):
    """Trace the scope with torch.profiler (CPU, and CUDA where present)
    and write a Chrome trace, `<logdir>/trace.json` (default: a
    "vk3dgs_trace" directory in the temporary directory); yields the
    profiler, whose `key_averages()` give each kernel's device time.

    JAX's version wraps `jax.profiler.trace` for TensorBoard/XProf."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vk3dgs_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
