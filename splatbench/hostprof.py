"""A host profile of the port under one configuration and traffic mix,
read from the port's own spans (vk3dgaussiansplatting_tpu_torch.utils.
timing: a `frame` span a draw, a span a pass, a `sync` span a blocking
read):

    python3 -m splatbench.hostprof --config train7k_720p --traffic orbit \\
        --seed 2147483701 --seconds 3 --frames 48

Not a cell and never run by the benchmark's runs: any configuration of
`configs/` under any traffic of `workloads/`, set up as run.py sets up a
cell (the scene from `--seed`, calibrated; the traffic's warm-up).  Then:

  windows   closed loops of `--seconds`, untraced and traced with the
            host-only tracer `CudaPassTimer(device_events=False)` in turns
            (off, on, on, off): frame_ms on the host clock, the cost of
            tracing on;
  spans     of the traced windows: each span's host total and self ms a
            frame (self: less its child spans), `host_frame_ms` (the
            `frame` spans less the `sync` spans inside them), syncs and
            counters a frame; the syncs torch's sync debug mode reports in
            8 traced frames (file:line), beside the `sync` spans of those
            frames;
  slices    (the card only) three torch.profiler slices of `--frames`
            frames: device activity without the tracer (run.py's first
            slice), device and host activity without it (its second), and
            with the host-only tracer; each slice's device ms a frame and
            idle share; of the last, the idle split (`idle_split`): inside
            a port span outside `sync` (`idle_host_paced_pct`), inside a
            `sync`, outside the port; the host's CUDA runtime calls by
            the innermost port span around them.  The device's busy time
            leaves out the profiler's GPU user annotations of the spans.

One JSON line on stdout; a summary on stderr.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import warnings

from vk3dgaussiansplatting_tpu_torch.utils.timing import FRAME, PROFILER_PREFIX as PREFIX, SYNC

from . import spec

TOP = 12


def _union(intervals) -> list[tuple[float, float]]:
    """The sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two disjoint sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def idle_split(gaps, cpu) -> dict:
    """The device's idle gaps [(start_us, end_us)] split by what the port's
    host was in (`cpu`: the host's profiler events (name, start_us,
    end_us), among them the port's `vk3d/<span>` events): `in_port_us`
    inside a `vk3d/frame` event and outside every `vk3d/sync` event,
    `in_sync_us` inside a `vk3d/sync`, `outside_us` the rest."""
    gaps = _union(gaps)
    frames = _union((s, e) for n, s, e in cpu if n == PREFIX + FRAME)
    syncs = _union((s, e) for n, s, e in cpu if n == PREFIX + SYNC)
    idle = _length(gaps)
    in_frame = _intersect(gaps, frames)
    in_port = _length(in_frame) - _length(_intersect(in_frame, syncs))
    in_sync = _length(_intersect(gaps, syncs))
    return {"idle_us": idle, "in_port_us": in_port, "in_sync_us": in_sync,
            "outside_us": idle - in_port - in_sync}


def runtime_calls(cpu, top: int = TOP) -> list:
    """[[innermost port span, CUDA runtime call, us]] summed over the
    host's `cuda*` events, the largest first ("(outside the port)" where
    no port span encloses the call)."""
    port = sorted(((s, e, n[len(PREFIX):]) for n, s, e in cpu if n.startswith(PREFIX)),
                  key=lambda x: (x[0], -x[1]))
    by: dict[tuple[str, str], float] = {}
    for n, s, e in cpu:
        if not n.startswith("cuda"):
            continue
        inner = "(outside the port)"
        for ps, pe, pn in port:
            if ps > s:
                break
            if e <= pe:
                inner = pn  # later starts are nested deeper
        by[(inner, n)] = by.get((inner, n), 0.0) + (e - s)
    return [[a, b, v] for (a, b), v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def span_summary(spans, counts: dict) -> dict:
    """A tracer's spans and counts over its frames: each span's host
    (total, self) ms a frame, `host_frame_ms` (the frames' spans less the
    `sync` spans inside them, a frame), syncs and counters a frame."""
    frames = counts.get(FRAME, 0)
    if not frames:
        return {}
    total: dict[str, list[float]] = {}
    sync_in_frames = 0
    for s in spans:
        acc = total.setdefault(s.name, [0.0, 0.0])
        acc[0] += (s.end_ns - s.start_ns) / 1e6
        acc[1] += s.self_ns / 1e6
        if s.name == SYNC and s.frame is not None:
            sync_in_frames += s.end_ns - s.start_ns
    return {
        "frames": frames,
        "spans_ms": {n: [t / frames, own / frames] for n, (t, own) in total.items()},
        "host_frame_ms": (total[FRAME][0] - sync_in_frames / 1e6) / frames,
        "syncs_per_frame": counts.get(SYNC, 0) / frames,
        "counts": {n: c for n, c in counts.items() if n not in total},
    }


def _sync_debug(fn) -> dict:
    """{"file:line": count} of the synchronisations torch's sync debug mode
    reports while `fn` runs."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def load(config: str, traffic: str) -> spec.Cell:
    """`configs/<config>.json` under `workloads/<traffic>.json`, as a cell
    that BENCHMARK.json need not list."""
    return spec.Cell(name=f"{config}.{traffic}", chips=1,
                     config=json.loads((spec.HERE / "configs" / f"{config}.json").read_text()),
                     traffic=json.loads((spec.HERE / "workloads" / f"{traffic}.json").read_text()),
                     limits={}, end_to_end=[], per_layer=[])


def profile_host(cell: spec.Cell, seed: int, seconds: float, frames: int,
                 device: str = "cuda") -> dict:
    """The profile of the module docstring; on the CPU the windows and spans
    alone (the port's plain versions)."""
    import torch

    from vk3dgaussiansplatting_tpu_torch import Renderer
    from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
    from vk3dgaussiansplatting_tpu_torch.utils.timing import CudaPassTimer

    from . import run
    from . import trace as tr

    dev = torch.device(device)
    on_chip = dev.type == "cuda"
    if on_chip:
        from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build

        _build.load_library()
    cloud, orbit, _fr, mult, live0 = run.make_scene(cell, seed, dev)
    traffic = cell.traffic
    renderer = Renderer(run.render_config(cell), device=dev, steady_frac=traffic["steady_frac"])
    renderer.init_for_scene(GaussianTable(*cloud))
    new_event = (lambda: torch.cuda.Event(enable_timing=True)) if on_chip else run.HostEvent
    in_flight = traffic["frames_in_flight"]
    drawn = [0]

    def loop(timer=None, **kw):
        first = drawn[0]
        ends, wall = run.closed_loop(
            lambda i: renderer.draw(orbit.camera(first + i), timer=timer), new_event, in_flight,
            **kw)
        drawn[0] += len(ends)
        return len(ends), wall

    loop(frames=traffic["warmup_frames"])
    out = {"config": cell.name, "seed": seed, "scale": mult, "live_centre": live0,
           "device": torch.cuda.get_device_name(dev) if on_chip else "cpu",
           "power_limit": run.power_limit() if on_chip else None}

    timer = CudaPassTimer(device_events=False)
    windows = []
    for traced in (False, True, True, False):
        n, wall = loop(timer if traced else None, seconds=seconds)
        windows.append({"traced": traced, "frames": n, "frame_ms": wall * 1e3 / n})
    out["windows"] = windows
    out["spans"] = span_summary(timer.spans(), timer.counts())
    off = [w["frame_ms"] for w in windows if not w["traced"]]
    on = [w["frame_ms"] for w in windows if w["traced"]]
    out["tracing_cost_ms"] = statistics.mean(on) - statistics.mean(off)

    if on_chip:
        few = CudaPassTimer(device_events=False)
        reported = _sync_debug(lambda: loop(few, frames=8))
        out["sync_check"] = {"frames": 8, "sync_debug_mode": reported,
                             "sync_spans": few.counts().get(SYNC, 0)}
        slices = {}
        for name, host, traced in (("device", False, False), ("host", True, False),
                                   ("traced", True, True)):
            slice_timer = CudaPassTimer(device_events=False) if traced else None
            dev_ev, cpu_ev = tr.profile(lambda: loop(slice_timer, frames=frames), host=host)
            # Kineto gives each `vk3d/` range a device event too, a GPU user
            # annotation over the kernels it launched: not device work.
            kernels = [e for e in dev_ev if not e[0].startswith(PREFIX)]
            busy_s, window_s, gaps = tr.busy(kernels)
            s = {"annotations": len(dev_ev) - len(kernels),
                 "device_ms_per_frame": window_s * 1e3 / frames,
                 "device_idle_pct": 100.0 * (1.0 - busy_s / window_s) if window_s else None}
            if traced:
                split = idle_split(gaps, cpu_ev)
                s.update(split, idle_host_paced_pct=100.0 * split["in_port_us"] / 1e6 / window_s,
                         spans=span_summary(slice_timer.spans(), slice_timer.counts()),
                         runtime_calls=runtime_calls(cpu_ev),
                         idle_gaps=tr.named_gaps(gaps, [e for e in cpu_ev
                                                        if not e[0].startswith(PREFIX)]))
            slices[name] = s
        out["slices"] = slices
        out["slice_tracing_cost_ms"] = (slices["traced"]["device_ms_per_frame"]
                                        - slices["device"]["device_ms_per_frame"])
    return out


def _summary(out: dict) -> str:
    lines = [f"{out['config']} seed {out['seed']} on {out['device']} ({out['power_limit']}): "
             + ", ".join(f"{'on' if w['traced'] else 'off'} {w['frame_ms']:.4f}"
                         for w in out["windows"])
             + f" ms a frame; tracing costs {out['tracing_cost_ms']:+.4f} ms"]
    sp = out["spans"]
    lines.append(f"host_frame_ms {sp['host_frame_ms']:.4f}, syncs {sp['syncs_per_frame']:g} a "
                 f"frame, counts {sp['counts']}; host (total, self) ms a frame: "
                 + ", ".join(f"{n} {t:.4f}/{o:.4f}" for n, (t, o) in sp["spans_ms"].items()))
    for name, s in out.get("slices", {}).items():
        line = (f"slice {name}: {s['device_ms_per_frame']:.4f} device ms a frame, idle "
                f"{s['device_idle_pct']:.3f}%")
        if "idle_us" in s:
            line += (f"; idle {s['idle_us']:.1f} us: in a port span {s['in_port_us']:.1f} "
                     f"(idle_host_paced_pct {s['idle_host_paced_pct']:.4f}), in sync "
                     f"{s['in_sync_us']:.1f}, outside the port {s['outside_us']:.1f}; runtime "
                     f"calls {s['runtime_calls']}")
        lines.append(line)
    if "sync_check" in out:
        lines.append(f"sync check: {out['sync_check']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = profile_host(load(args.config, args.traffic), args.seed, args.seconds, args.frames,
                       args.device)
    print(_summary(out), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
