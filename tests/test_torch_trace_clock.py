"""The port's host spans on torch.profiler's clock (utils.timing: ClockMap,
clock_offset, `profiler_ranges`), the join of device operations to the
spans by launch (splatbench/launches.py), the `project` span around K7 on
each frame path, and the readers of the two metrics the join feeds.  The
last two tests need the card: a CUDA-only profile has no device events on
the CPU."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from splatbench import launches, metrics
from vk3dgaussiansplatting_tpu_torch import Renderer, RenderConfig, pipeline
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
from vk3dgaussiansplatting_tpu_torch.utils import timing

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=48, capacity_slack_per_tile=16)
CAPPED = dataclasses.replace(CFG, blend_depth_cap=384, blend_cap_max=4096)
CPU, CUDA = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA


def _scene(config):
    scene = synthetic.SimpleTestGaussiansScene(aspect=config.aspect)
    scene.init()
    scene.camera.set_aspect(config.aspect)
    return scene


def _renderer(config, scene, device="cpu"):
    r = Renderer(config, device=device)
    r.init_for_scene(scene.gaussians())
    return r


class _FakeEvent:
    """A CUDA event's interface, for counting the pairs a timer records."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_mapped_span_sits_in_its_profiler_range():
    assert timing.ClockMap.of((100, 5), (110, 7)) == (105, 12, 10)
    assert timing.ClockMap(105, 0, 0).map(1) == 106
    timer = timing.CudaPassTimer(device_events=False)
    quiet = timing.CudaPassTimer(device_events=False, profiler_ranges=False)
    # The first range of a process costs ~1 ms of the profiler's set-up.
    with torch.profiler.profile(activities=[CPU]):
        with timer.section("warm"):
            pass
    opened = timing.clock_offset()
    with torch.profiler.profile(activities=[CPU]) as prof:
        for i in range(4):
            with timer.section(f"s{i}"):
                sum(range(20000))
            with quiet.section("quiet"):
                pass
    cmap = timing.ClockMap.of(opened, timing.clock_offset())
    assert 0 <= cmap.error_ns < 100_000
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert timing.PROFILER_PREFIX + "quiet" not in events and len(quiet.spans()) == 4
    slack = cmap.error_ns + 2_000
    for s in timer.spans()[1:]:
        e = events[timing.PROFILER_PREFIX + s.name]
        lead = cmap.map(s.start_ns) - e.start_ns()
        lag = e.end_ns() - cmap.map(s.end_ns)
        # The range opens just before its span and closes just after it:
        # record_function's own microseconds, not the ~1.8e18 ns between
        # CLOCK_MONOTONIC and CLOCK_REALTIME.
        assert -slack <= lead < 1_000_000 and -slack <= lag < 1_000_000, (lead, lag)


def _span(name, start, end):
    return timing.Span(name, 0, None, start, end, 0)


def test_join_puts_each_gap_down_to_its_late_launch():
    # Span times on the tracer's clock; the map adds 1000 ns.
    spans = [_span("project", 150, 300), _span("keygen", 100, 500), _span("sort", 500, 900),
             _span("frame", 0, 1000)]
    calls = {6: ("cudaLaunchKernel", 1120, 1130),  # keygen, outside project
             1: ("cudaLaunchKernel", 1160, 1170),  # project
             2: ("cudaLaunchKernel", 1180, 1190),  # project, queued before its gap
             3: ("cuLaunchKernel", 1610, 1640),  # sort, late into its gap
             5: ("cudaMemsetAsync", 2100, 2110),  # after the frame
             9: ("cudaEventSynchronize", 2115, 2200)}  # launches nothing
    ops = [("k", 1200, 1400, 1), ("k", 1140, 1200, 6), ("k", 1500, 1600, 2),
           ("k", 1660, 1700, 3), ("k", 1750, 1800, 4), ("memset", 2120, 2130, 5)]
    j = launches.join(ops, calls, spans, timing.ClockMap(1000, 0, 0), frames=2)
    assert j["window_ns"] == 2130 - 1140 and j["idle_ns"] == 100 + 60 + 50 + 320
    assert j["span_ns"] == {"keygen": 60, "project": 300, "sort": 40,
                            launches.NO_LAUNCH: 50, launches.OUTSIDE: 10}
    assert j["within_ns"] == {"frame": 400, "keygen": 360, "project": 300, "sort": 40}
    # Op 2's call ended before its gap began: all of the gap is the device's.
    # Op 3's call ended 40 ns into its 60 ns gap; the memset's 310 ns into
    # its 320.  Op 4's launch is not in the trace.
    assert j["late_ns"] == {"project": 0, "sort": 40, launches.OUTSIDE: 310}
    assert j["device_side_ns"] == {"project": 100, "sort": 20, launches.OUTSIDE: 10}
    assert j["no_launch_idle_ns"] == 50
    assert (j["gaps"], j["ops"], j["no_launch"], j["straddles"], j["early"]) == (4, 6, 1, 0, 0)
    read = {n: metrics.load(n) for n in launches.METRICS}
    r = SimpleNamespace(launches=j)
    assert read["idle_launch_late_pct"](r) == pytest.approx(100.0 * 350 / 990)
    assert read["project_ms"](r) == pytest.approx(300 / 1e6 / 2)
    assert "6 ops, 1 with no launch, 0 calls across a span edge" in launches.summary(j)
    # An op before its call: Kineto's clocks disagree in this slice.
    j = launches.join([("k", 0, 10, 1)], {1: ("cudaLaunchKernel", 5, 8)}, [],
                      timing.ClockMap(0, 0, 0), frames=1)
    assert (j["early"], j["early_ns"]) == (1, 5)


def test_a_slice_whose_clocks_disagree_is_taken_again(monkeypatch):
    timer = timing.CudaPassTimer(device_events=False, profiler_ranges=False)
    takes = iter([(10, 5), (10, 12), (10, 20)])  # (op start, call start)

    def profile(draw):
        draw()
        start, call = next(takes)
        return ([("k", start, start + 5, 1)], {1: ("cudaLaunchKernel", call, call + 1)},
                timing.ClockMap(0, 0, 0))

    def draw():
        for _ in range(2):
            with timer.section("frame"):
                pass

    monkeypatch.setattr(launches, "profile_launches", profile)
    j, ops = launches.launch_slice(draw, timer)
    assert (j["takes"], j["early"], j["frames"], ops) == (1, 0, 2, [("k", 10, 15, 1)])
    takes = iter([(10, 12), (10, 11), (10, 5)])
    j, _ = launches.launch_slice(draw, timer)
    assert (j["takes"], j["early"], j["frames"]) == (3, 0, 2)
    takes = iter([(10, 12)] * 3)
    j, _ = launches.launch_slice(draw, timer)
    assert (j["takes"], j["early"], j["early_ns"]) == (3, 1, 2)

def test_metric_readers_need_their_readings():
    read = {n: metrics.load(n) for n in launches.METRICS}
    bare = metrics.Readings(10, {"keygen": 5.0}, {}, None, None, 48, 0.9, 1.0)
    assert {n: f(bare) for n, f in read.items()} == {n: None for n in read}
    # A join with no device op, and one of a program with no `project` span.
    empty = launches.join([], {}, [], timing.ClockMap(0, 0, 0), frames=48)
    assert {n: f(SimpleNamespace(launches=empty)) for n, f in read.items()} == {
        n: None for n in read}
    j = launches.join([("k", 0, 10, 1)], {1: ("cudaLaunchKernel", -5, -1)},
                      [_span("keygen", -10, 0)], timing.ClockMap(0, 0, 0), frames=1)
    assert j["span_ns"] == {"keygen": 10}
    assert read["project_ms"](SimpleNamespace(launches=j)) is None


@pytest.mark.parametrize("path", ["uncapped", "static_cap", "temporal"])
def test_project_span_nests_under_keygen(path, monkeypatch):
    config = CFG if path == "uncapped" else CAPPED
    scene = _scene(config)
    r = _renderer(config, scene)

    def draw(timer):
        if path == "static_cap":
            # The static cap is `render_frame`'s; Renderer's capped frame is
            # the temporal one.
            view, proj = scene.camera.matrices()
            with timing.section(timer, "frame"):
                pipeline.render_frame(r.table, view, proj, scene.camera.position,
                                      config=config, capacity=r.capacity, timer=timer)
        else:
            r.draw(scene.camera, timer=timer)

    timer = timing.CudaPassTimer(device_events=False)
    for _ in range(2):
        draw(timer)
    spans = timer.spans()
    project = [s for s in spans if s.name == "project"]
    assert {s.frame for s in project} == {0, 1} and {s.parent for s in project} == {"keygen"}
    for p in project:
        assert any(k.name == "keygen" and k.frame == p.frame
                   and k.start_ns <= p.start_ns <= p.end_ns <= k.end_ns for k in spans)
    # The event-timed window gets no pair for it.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    events = timing.CudaPassTimer()
    draw(events)
    assert "project" in timing.HOST_ONLY
    assert "keygen" in events.totals() and "project" not in events.totals()


@pytest.mark.cuda
def test_span_holds_the_spin_kernel_on_the_shared_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA-only profile records no device event on the CPU")
    timer = timing.CudaPassTimer(device_events=False, profiler_ranges=False)
    torch.cuda.synchronize()
    opened = timing.clock_offset()
    with torch.profiler.profile(activities=[CUDA]) as prof:
        # The trace can lose its first device operations: a spin outside
        # the span goes first, as in every profiled slice.
        torch.cuda._sleep(launches.tr.SPIN_CYCLES)
        with timer.section("spin"):
            torch.cuda._sleep(launches.tr.SPIN_CYCLES)
            torch.cuda.synchronize()
    cmap = timing.ClockMap.of(opened, timing.clock_offset())
    (span,) = timer.spans()
    events = prof.profiler.kineto_results.events()
    spin = max((e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                and launches.tr.SPIN_NAME in e.name()), key=lambda e: e.start_ns())
    call = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.correlation_id() == spin.correlation_id()
            and e.name().startswith(launches.CALL_PREFIX)]
    assert call
    lo, hi = cmap.map(span.start_ns) - cmap.error_ns, cmap.map(span.end_ns) + cmap.error_ns
    for e in [spin] + call:
        assert lo <= e.start_ns() <= e.end_ns() <= hi, (e.name(), lo, e.start_ns(), e.end_ns(), hi)


@pytest.mark.cuda
def test_every_device_op_of_a_small_draw_finds_its_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA-only profile records no device event on the CPU")
    scene = _scene(CFG)
    r = _renderer(CFG, scene, "cuda")
    r.draw(scene.camera)
    timer = timing.CudaPassTimer(device_events=False, profiler_ranges=False)
    j, _ = launches.launch_slice(lambda: [r.draw(scene.camera, timer=timer) for _ in range(3)],
                                 timer)
    assert j["ops"] > 0 and j["frames"] == 3, j
    assert (j["no_launch"], j["straddles"], j["early"]) == (0, 0, 0), j
    assert {"project", "expand", "blend"} <= set(j["span_ns"])
    assert j["within_ns"]["frame"] == sum(v for n, v in j["span_ns"].items()
                                          if n != launches.OUTSIDE)
    assert sum(j["late_ns"].values()) + sum(j["device_side_ns"].values()) == j["idle_ns"]
