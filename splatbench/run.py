"""One run of one cell of the benchmark of vk3dgaussiansplatting_tpu_torch.

    python3 -m splatbench.run --workload garden-orbit --seed 7 --seconds 10 --trace 0

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (it exits non-zero, printing no result, without them).

Before set-up, the cell's render settings are checked against what the
reference models (`render_settings`); a setting it cannot judge is refused
and the run exits non-zero with no result.

Set-up (`setup_s`, from the process's start to the window's): import, load
the port's CUDA library (nvcc builds it into the package's `_build/` on a
checkout's first run), make the scene on the card from `--seed`,
calibrate its scale to the configuration's live element count with the
reference's projection, build `Renderer` with the cell's RenderConfig and
give it the table, draw the traffic's warm-up frames.

The window: `Renderer.draw` in a closed loop for `--seconds`, the camera
on the traffic's loop of poses, at most `frames_in_flight` frames queued
(before frame N the host waits on frame N-3's end event, as the reference
viewer's FRAMES_IN_FLIGHT), an end event recorded after every draw and
each frame's image kept until its event completes.
  frame_ms      the window's wall time, to the last frame's end event, over
                its frames;
  frame_p95_ms  the 95th percentile over every frame of the time between
                consecutive end events (CUDA events, the device's clock).
With `--trace 1` the window also carries the port's CudaPassTimer (its
events cost the host time, so the sections, not `frame_ms`, are read from
it), and two profiled slices of `trace_frames` frames without the timer
follow it (device activity alone, for the idle share and the frame's
device time; with the host's, for the idle gaps' names).  Then the host:
a closed loop of 4 x `trace_frames` frames under the host-only tracer
(CudaPassTimer(device_events=False)) with no profiler running, for the
host's time a frame, and a third profiled slice of `trace_frames` frames
under it, device and host activity, for the device's idle time by what
the host was in (splatbench.hostprof's span_summary and idle_split).  The
result then holds the cell's per-layer metrics (metrics/<name>.py) and
`breakdown`.

After the window: `attempted` is its frames, `failed` those the port
flagged as not exact (`FrameOutputs.ok` False); the frames kept at the
traffic's `kept_frames`, the first frame of the window that took each of
the capped blend's patch pass and full fallback (ops/capped.PATH_COUNTS),
and the last frame are rendered again by the reference (reference.py) and
compared (judge.py) into `correct`; the
numbers compared go, each beside its limit, to the last lines of stderr
and under "checks", last, in the result: the last line of stdout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402

from . import guard, judge, spec  # noqa: E402

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class HostEvent:
    """A CUDA event's interface on the host clock, for runs on the CPU."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def closed_loop(draw, new_event, in_flight: int, *, frames=None, seconds=None, on_frame=None):
    """Draw frames 0, 1, ... (`draw(i)` -> FrameOutputs) until `frames` or
    `seconds` are reached, at most `in_flight` queued.  Returns (the end
    events, wall seconds to the last one's completion)."""
    pending, ends = deque(), []
    t0 = time.perf_counter()
    i = 0
    while (frames is None or i < frames) and (seconds is None
                                              or time.perf_counter() - t0 < seconds):
        if len(pending) == in_flight:
            pending.popleft()[0].synchronize()
        out = draw(i)
        ev = new_event()
        ev.record()
        pending.append((ev, out.image_u8))
        ends.append(ev)
        if on_frame is not None:
            on_frame(i, out)
        i += 1
    if ends:
        ends[-1].synchronize()
    return ends, time.perf_counter() - t0


def render_settings(cell: spec.Cell) -> dict:
    """The cell's render settings: the configuration's `render` group with
    the traffic's over it.  Refused (ValueError, naming the key): a key
    RenderConfig lacks; a setting of the reference's MODELLED set that the
    settings leave to RenderConfig's default, which the reference would not
    see; and a key the reference neither models nor lists as IMAGE_NEUTRAL,
    set away from its default."""
    import dataclasses

    from vk3dgaussiansplatting_tpu_torch import RenderConfig

    from . import reference

    kw = dict(cell.config["render"])
    kw.update(cell.traffic.get("render", {}))
    fields = {f.name: f for f in dataclasses.fields(RenderConfig)}
    unknown = sorted(set(kw) - set(fields))
    if unknown:
        raise ValueError(f"render setting {unknown[0]!r}: RenderConfig has no such field")
    missing = sorted(reference.MODELLED - set(kw))
    if missing:
        raise ValueError(f"render setting {missing[0]!r}: the reference models it, and the "
                         f"cell leaves it to RenderConfig's default")
    rc = _render_config(kw)
    unmodelled = [k for k in sorted(set(kw) - reference.MODELLED - reference.IMAGE_NEUTRAL)
                  if getattr(rc, k) != fields[k].default]
    if unmodelled:
        key = unmodelled[0]
        raise ValueError(f"render setting {key!r} = {kw[key]!r}: the reference does not model "
                         f"it, nor is it known to leave the frame as it is")
    return kw


def _render_config(kw: dict):
    from vk3dgaussiansplatting_tpu_torch import RenderConfig, SortAlgorithm, SphericalHarmonicsMode

    kw = dict(kw)
    kw["sh_mode"] = SphericalHarmonicsMode(kw["sh_mode"])
    kw["sort_algorithm"] = SortAlgorithm(kw["sort_algorithm"])
    return RenderConfig(**kw)


def render_config(cell: spec.Cell):
    """The port's RenderConfig of the cell's render settings."""
    return _render_config(render_settings(cell))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def make_scene(cell: spec.Cell, seed: int, dev):
    """The cell's scene from `seed`, calibrated: (cloud, orbit, the
    reference's Frame, scale multiplier, live elements at the centre)."""
    from . import reference, scene

    cfg, loop = cell.config, cell.traffic["camera"]
    fr = reference.frame_constants(render_settings(cell), cfg["gaussians"])
    if fr.capacity != cfg["capacity"]:
        raise RuntimeError(f"capacity: the reference's {fr.capacity}, the configuration's "
                           f"{cfg['capacity']}")
    cloud = scene.make_cloud(cfg["gaussians"], cfg["assumed"]["cloud"], seed, dev)
    orbit = scene.Orbit(cfg["assumed"]["camera"], fr.width / fr.height, loop["poses"],
                        loop["step"], seed)
    mult, live0 = scene.calibrate(cloud, orbit.centre(), fr, cfg["target_live"],
                                  cfg["calibration_tolerance"])
    return scene.scaled(cloud, mult), orbit, fr, mult, live0


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0):
    """Run `cell` once; returns (result line dict, checks dict).  `device`
    "cpu" runs the port's plain versions and the host clock (the tests)."""
    import torch

    from vk3dgaussiansplatting_tpu_torch import Renderer
    from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
    from vk3dgaussiansplatting_tpu_torch.ops import capped as capped_ops
    from vk3dgaussiansplatting_tpu_torch.utils.timing import PROFILER_PREFIX, CudaPassTimer

    from . import hostprof, metrics, reference
    from . import trace as tr
    from .metrics import work

    dev = torch.device(device)
    on_chip = dev.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    phases = {"import": time.perf_counter() - t0}

    def phase(name):
        if on_chip:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t0 - sum(phases.values())

    rc = render_config(cell)
    if on_chip:
        from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build

        _build.load_library()
        phase("library")
    n = cfg["gaussians"]
    if rc.sort_capacity(n) != cfg["capacity"]:
        raise RuntimeError(f"capacity: the port's {rc.sort_capacity(n)}, the configuration's "
                           f"{cfg['capacity']}")
    cloud, orbit, fr, mult, live0 = make_scene(cell, seed, dev)
    phase("scene")
    renderer = Renderer(rc, device=dev, steady_frac=traffic["steady_frac"])
    renderer.init_for_scene(GaussianTable(*cloud))

    def draws(first, timer=None):
        return lambda i: renderer.draw(orbit.camera(first + i), timer=timer)

    new_event = (lambda: torch.cuda.Event(enable_timing=True)) if on_chip else HostEvent
    in_flight = traffic["frames_in_flight"]
    warm = traffic["warmup_frames"]
    closed_loop(draws(0), new_event, in_flight, frames=warm)
    phase("warm-up")

    # The window.
    timer = CudaPassTimer() if trace and on_chip else None
    kept_at = set(traffic["kept_frames"])
    kept, oks, last = {}, [], {}
    live = [torch.zeros((), dtype=torch.int64, device=dev)]
    # The capped blend's branch counts: the first frame of the window on
    # each path other than the fast one is kept too.
    seen = dict(capped_ops.PATH_COUNTS)
    path_kept = {}

    def on_frame(i, out):
        for path in ("patch", "full"):
            if capped_ops.PATH_COUNTS[path] > seen[path] and path not in path_kept:
                path_kept[path] = i
                kept[i] = (out.image_u8, out.ok)
        seen.update(capped_ops.PATH_COUNTS)
        if i in kept_at:
            kept[i] = (out.image_u8, out.ok)
        last["frame"] = (i, out.image_u8, out.ok)
        if out.ok is not None:
            oks.append(out.ok)
        if trace:
            live[0] = live[0] + out.num_elements

    counts0 = dict(capped_ops.PATH_COUNTS)
    setup_s = time.perf_counter() - t0
    start = new_event()
    start.record()
    ends, wall = closed_loop(draws(warm, timer), new_event, in_flight, seconds=seconds,
                             on_frame=on_frame)
    frames = len(ends)
    intervals = [a.elapsed_time(b) for a, b in zip([start] + ends[:-1], ends)]
    e2e = {"frame_ms": wall * 1e3 / frames, "frame_p95_ms": p95(intervals), "setup_s": setup_s}
    failed = int((~torch.stack(oks)).sum()) if oks else 0
    path_counts = {k: capped_ops.PATH_COUNTS[k] - counts0[k] for k in counts0}
    peak = torch.cuda.max_memory_allocated(dev) if on_chip else 0
    sections = timer.totals() if timer is not None else {}
    live_mean = float(live[0]) / frames if trace else None
    log(f"{cell.name} seed {seed}: scale x{mult:.6f}, live {live0} at the centre pose; "
        f"{frames} frames in {wall:.3f} s, frame_ms {e2e['frame_ms']:.4f}, p95 "
        f"{e2e['frame_p95_ms']:.4f}, setup {setup_s:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in phases.items())}), failed {failed}, paths "
        f"{path_counts}, peak {peak}")

    busy_s = window_s = None
    breakdown = None
    host_spans = host_idle = host_slice_s = None
    if trace:
        k = traffic["trace_frames"]
        first = [warm + frames]

        def traced(host, tracer=None):
            # A slice the profiler returned empty is taken again.
            for _ in range(3):
                dev_ev, cpu_ev = tr.profile(
                    lambda: closed_loop(draws(first[0], tracer), new_event, in_flight, frames=k),
                    host=host)
                first[0] += k
                # Kineto gives each `vk3d/` section a device event too, a GPU
                # user annotation over the kernels it launched: not device work.
                dev_ev = [e for e in dev_ev if not e[0].startswith(PROFILER_PREFIX)]
                if dev_ev:
                    return dev_ev, cpu_ev
            raise RuntimeError("the profiler recorded no device operation in three slices")

        if on_chip:
            dev_ev, _ = traced(False)
            busy_s, window_s, _ = tr.busy(dev_ev)
            dev2, cpu2 = traced(True)
            breakdown = {"device_ops": tr.top_ops(dev_ev),
                         "idle_gaps": tr.named_gaps(tr.busy(dev2)[2], cpu2)}
        # The host, after every other reading: its spans over a loop with no
        # profiler running, then the device's idle time by those spans.
        t_host = time.perf_counter()
        host_timer = CudaPassTimer(device_events=False)
        closed_loop(draws(first[0], host_timer), new_event, in_flight, frames=4 * k)
        first[0] += 4 * k
        host_spans = hostprof.span_summary(host_timer.spans(), host_timer.counts())
        msg = (f"host: {host_spans['frames']} frames under the host-only tracer, "
               f"host_frame_ms {host_spans['host_frame_ms']:.4f}, "
               f"{host_spans['syncs_per_frame']:g} syncs a frame")
        if on_chip:
            dev3, cpu3 = traced(True, CudaPassTimer(device_events=False))
            _, host_slice_s, gaps = tr.busy(dev3)
            host_idle = hostprof.idle_split(gaps, cpu3)
            idle = ", ".join(f"{n} {v:.1f}" for n, v in host_idle.items())
            msg += f"; its profiled slice {host_slice_s * 1e3:.3f} ms, {idle}"
        log(f"{msg}; {time.perf_counter() - t_host:.3f} s")

    # The program's state goes before the reference runs.
    del renderer, timer, oks, ends, start
    gc.collect()
    if on_chip:
        torch.cuda.empty_cache()
    readings, work_counts = [], None
    last_i = last["frame"][0]
    checked = sorted((i, img, ok) for i, (img, ok) in kept.items() if i != last_i)
    flagged = 0
    for i, img, ok in checked + [last["frame"]]:
        flagged += ok is not None and not bool(ok)
        cam = orbit.camera(warm + i)
        view, proj = cam.matrices()
        ref_img, p, s, rows = reference.render(cloud, view, proj, cam.position, fr)
        readings.append(judge.compare(img, ref_img))
        if trace and i == last_i:
            pairs, eligible = work.saturating_pairs(
                rows, s.index, s.ranges, width=fr.width, height=fr.height, tile=fr.tile,
                cutoff=fr.alpha_cutoff, stop=fr.stop)
            work_counts = {"gaussians": n, "visible": int(p.visible.sum()),
                           "pixels": fr.width * fr.height, "pairs": pairs, "eligible": eligible}
        del p, s, rows, ref_img
    correct, checks = judge.judge(readings, cell.limits)
    log(f"compared {len(readings)} frames (window indices {[i for i, *_ in checked]} and the "
        f"last, {last_i}; first frames on the patch and full paths {path_kept}), {flagged} of "
        f"them flagged by the port; work {work_counts}")

    if trace:
        r = metrics.Readings(frames, sections, path_counts, live_mean, work_counts,
                             traffic["trace_frames"], busy_s, window_s, host_spans=host_spans,
                             host_idle=host_idle, host_slice_s=host_slice_s)
        values = {m["name"]: (metrics.load(m["name"])(r) if on_chip else None, m["unit"])
                  for m in cell.per_layer}
    else:
        values = {m["name"]: (e2e[m["name"]], m["unit"]) for m in cell.end_to_end}
    result = {
        "correct": correct,
        "attempted": frames,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items() if v is not None},
        "device": {"platform": "gpu" if on_chip else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_chip else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace and on_chip:
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    if on_chip:
        result["device"]["power_limit"] = power_limit()
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden_modules(sys.modules)
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
