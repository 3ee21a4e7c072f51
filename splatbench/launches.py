"""The device's work and idle put down to the port's host spans by launch.

A profiled slice of device activity alone (CUPTI's kernels, copies and
memsets, and the CUDA API calls that launched them), drawn under the
host-only tracer `CudaPassTimer(device_events=False,
profiler_ranges=False)`, whose spans open no profiler range and reach the
trace's clock by `utils.timing.ClockMap`.  Each device operation is joined
to its launch call by CUPTI's correlation id, and so to the innermost span
open when that call began ("outside draw" where none was; "(no launch)"
where the call is not in the trace):

  span_ns      device ns of the operations launched with each span
               innermost; `within_ns` with the span anywhere on the stack;
  idle         each gap [g0, g1] of the device, from the slice's first
               operation to its last, has a host-late part,
               max(0, min(g1, end of L) - g0) for L the call that launched
               the operation ending the gap: the time the device waited for
               a launch the host had not yet made, put down to L's
               innermost span.  The rest of the gap is device-side, put
               down to the same span: the operation was queued, and the
               stream's own latency held it.

A slice in which Kineto puts an operation before the call that launched
it is taken again (`launch_slice`): there its device and host clocks
disagree, and the split would be wrong.

`metrics/idle_launch_late_pct.py` and `metrics/project_ms.py` read the
join from a `launches` reading.  On a cell:

    python3 -m splatbench.launches --workload garden-orbit --seed 2147483701 --seconds 10

is run.py's traced run (`--trace 1`) with the launch slice drawn after its
third slice, the slice's frames again: run.py's result line with the two
metrics, the join and the slice's device operations, on stdout; run.py's
lines and the join's summary on stderr.  Not a cell's run.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from types import SimpleNamespace

from vk3dgaussiansplatting_tpu_torch.utils.timing import FRAME, ClockMap, clock_offset

from . import trace as tr

OUTSIDE = "outside draw"
NO_LAUNCH = "(no launch)"
# Under a CUDA-only profile Kineto's host events are the CUDA API calls
# (cudaLaunchKernel, cuLaunchKernel, cudaMemsetAsync, ...) and
# CUPTI's own work inside them ("Runtime Triggered Module Loading", ...),
# which shares the call's correlation id.
CALL_PREFIX = "cu"
METRICS = ("idle_launch_late_pct", "project_ms")


def profile_launches(run):
    """torch.profiler over `run()`, device activity only, opened by
    trace.py's spin kernel, with the clock offset read before and after.
    Returns (device ops [(name, start_ns, end_ns, correlation id)], calls
    {correlation id: (name, start_ns, end_ns)}, ClockMap), on Kineto's
    clock; the spin kernel and its launch left out."""
    import torch

    torch.cuda.synchronize()
    opened = clock_offset()
    with warnings.catch_warnings():
        # Without a schedule the profiler warns that it keeps one cycle.
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(tr.SPIN_CYCLES)
            run()
            torch.cuda.synchronize()
    cmap = ClockMap.of(opened, clock_offset())
    ops, calls, spin = [], {}, set()
    for e in prof.profiler.kineto_results.events():
        name, corr = e.name(), e.correlation_id()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if tr.SPIN_NAME in name:
                spin.add(corr)
            elif not e.is_user_annotation():
                ops.append((name, e.start_ns(), e.end_ns(), corr))
        elif name.startswith(CALL_PREFIX):
            # The outer call where a cuda* call's cu* call shares its id.
            if corr not in calls or e.start_ns() < calls[corr][1]:
                calls[corr] = (name, e.start_ns(), e.end_ns())
    return ops, {c: v for c, v in calls.items() if c not in spin}, cmap


def launch_slice(draw, tracer, tries: int = 3):
    """profile_launches over `draw()`, joined to the spans it adds to
    `tracer` (a host-only tracer with `profiler_ranges` off), its frames
    counted by their `frame` spans.  Taken again, up to `tries` times in
    all, while an op begins before its call: Kineto's device and host
    clocks then disagree (on an H100 with torch 2.11, 2 of 22 slices at
    garden's size, one by up to 0.5 ms with device durations 2% short).
    Returns (the join, with `takes`, the slice's ops)."""
    for take in range(1, tries + 1):
        first = len(tracer.spans())
        ops, calls, cmap = profile_launches(draw)
        spans = tracer.spans()[first:]
        j = join(ops, calls, spans, cmap, sum(s.name == FRAME for s in spans))
        if not j["early"]:
            break
    j["takes"] = take
    return j, ops


def _stacks(spans, times) -> list[tuple[int, ...]]:
    """For each time, the indices of the spans [(start, end, name)] open at
    it, outermost first.  Spans nest; at one instant a span closes, then
    one opens, then the time is read."""
    marks = [(s, 1, i) for i, (s, e, _n) in enumerate(spans)]
    marks += [(e, 0, i) for i, (_s, e, _n) in enumerate(spans)]
    marks += [(t, 2, j) for j, t in enumerate(times)]
    marks.sort()
    stack, out = [], [()] * len(times)
    for _t, kind, i in marks:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            stack.remove(i)
        else:
            out[i] = tuple(stack)
    return out


def join(ops, calls, spans, cmap: ClockMap, frames: int) -> dict:
    """The slice's ops and calls (profile_launches) joined to the tracer's
    spans (utils.timing.Span, mapped by `cmap`).  Returns ns over the
    slice: `span_ns`, `within_ns`; `late_ns` and `device_side_ns`, each by
    the span of the call that launched the op ending the gap;
    `no_launch_idle_ns` (gaps ended by an op whose call is not in the
    trace), `idle_ns`, `window_ns`; counts: `gaps`, `ops`, `no_launch`,
    `straddles` (calls that begin and end under different spans: the clock
    map is off by more than a call's distance to a span edge), `early` (ops
    that start before their call: Kineto's device and host clocks
    disagree) and `early_ns`, the most by which one does; `frames`, and
    `clock` (the map's error and drift)."""
    spans = [(cmap.map(s.start_ns), cmap.map(s.end_ns), s.name)
             for s in spans if s.end_ns > s.start_ns]
    ops = sorted(ops, key=lambda o: (o[1], o[2]))
    used = sorted({o[3] for o in ops if o[3] in calls})
    stacks = _stacks(spans, [calls[c][1] for c in used] + [calls[c][2] for c in used])
    at = dict(zip(used, stacks))  # the spans open as each call began
    straddles = sum(a != b for a, b in zip(stacks, stacks[len(used):]))

    launch = [calls.get(o[3]) for o in ops]
    names, span_ns, within_ns = [], {}, {}
    early = early_ns = 0
    for (_n, s, e, corr), call in zip(ops, launch):
        if call is None:
            name, path = NO_LAUNCH, ()
        else:
            path = at[corr]
            name = spans[path[-1]][2] if path else OUTSIDE
            early += s < call[1]
            early_ns = max(early_ns, call[1] - s)
        names.append(name)
        span_ns[name] = span_ns.get(name, 0) + (e - s)
        for n in {spans[i][2] for i in path}:
            within_ns[n] = within_ns.get(n, 0) + (e - s)

    late_ns, device_side_ns = {}, {}
    gaps = no_launch_idle = idle = 0
    if ops:
        first, cur_e = ops[0][1], ops[0][2]
        for (_n, s, e, _corr), call, name in zip(ops[1:], launch[1:], names[1:]):
            if s > cur_e:
                gap = s - cur_e
                gaps += 1
                idle += gap
                if call is None:
                    no_launch_idle += gap
                else:
                    late = max(0, min(s, call[2]) - cur_e)
                    late_ns[name] = late_ns.get(name, 0) + late
                    device_side_ns[name] = device_side_ns.get(name, 0) + gap - late
            cur_e = max(cur_e, e)
    return {"frames": frames, "window_ns": cur_e - first if ops else 0, "idle_ns": idle,
            "gaps": gaps, "late_ns": late_ns, "device_side_ns": device_side_ns,
            "no_launch_idle_ns": no_launch_idle, "span_ns": span_ns, "within_ns": within_ns,
            "ops": len(ops), "no_launch": launch.count(None), "straddles": straddles,
            "early": early, "early_ns": early_ns, "clock": cmap._asdict()}


def summary(j: dict) -> str:
    """The join as one line: the slice's idle share, its host-late and
    device-side parts by span (ms), each span's device ms a frame, and the
    count of ops with no launch."""
    f, w = j["frames"], j["window_ns"]

    def ms(by, scale=1):
        return ", ".join(f"{n} {v / 1e6 / scale:.4f}"
                         for n, v in sorted(by.items(), key=lambda kv: -kv[1])) or "none"

    return (f"launches: {f} frames, taken {j.get('takes', 1)} times, slice "
            f"{w / 1e6:.4f} ms, idle "
            f"{100.0 * j['idle_ns'] / w if w else 0.0:.4f}% in {j['gaps']} gaps: host-late "
            f"{ms(j['late_ns'])}; device-side {ms(j['device_side_ns'])}; ended by no launch "
            f"{j['no_launch_idle_ns'] / 1e6:.4f} ms; device ms a frame by span: "
            + ms(j["span_ns"], f)
            + f"; {j['ops']} ops, {j['no_launch']} with no launch, {j['straddles']} calls "
            f"across a span edge, {j['early']} before their call (by up to "
            f"{j['early_ns']} ns); clock error "
            f"{j['clock']['error_ns']} ns, drift {j['clock']['drift_ns']} ns")


def traced_run(cell, seed: int, seconds: float):
    """run.py's traced run of `cell` (`run_cell` with trace on), and the
    launch slice after its third slice: the third slice's draws profiled
    once more, device activity alone, with that slice's host-only tracer
    opening no profiler range.  Returns (result line, checks, join, the
    launch slice's device operations by time as trace.top_ops)."""
    from vk3dgaussiansplatting_tpu_torch.utils import timing

    from . import run

    tracers, out = [], {}

    class Tracer(timing.CudaPassTimer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            tracers.append(self)

    profile = tr.profile

    def profile_then_launches(draw, *, host):
        got = profile(draw, host=host)
        # The third slice is the one profiled with host activity under a
        # host-only tracer; run_cell builds that tracer just before it.
        if host and tracers and not tracers[-1].device_events and not out:
            tracer = tracers[-1]
            tracer.profiler_ranges = False
            out["join"], ops = launch_slice(draw, tracer)
            out["ops"] = tr.top_ops([(n, s / 1e3, e / 1e3) for n, s, e, _c in ops])
        return got

    timing.CudaPassTimer, tr.profile = Tracer, profile_then_launches
    try:
        result, checks = run.run_cell(cell, seed, seconds, True)
    finally:
        timing.CudaPassTimer, tr.profile = Tracer.__base__, profile
    return result, checks, out.get("join"), out.get("ops")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from . import metrics, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    result, checks, j, ops = traced_run(spec.load_cell(args.workload), args.seed, args.seconds)
    r = SimpleNamespace(launches=j)
    for name in METRICS:
        value = metrics.load(name)(r)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": "%" if name.endswith("pct")
                                       else "ms"}
    result.update(checks=checks, launches=j, launch_ops=ops)
    if j is not None:
        print(summary(j), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
