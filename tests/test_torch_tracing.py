"""The port's tracing (utils/timing.py) on the CPU, with the host-only
tracer `CudaPassTimer(device_events=False)`: one span tree a frame, self
times, the host synchronisations (`read_back`'s `sync` spans) a frame on
each frame path, the chained plan's steady-switch counters, frames equal
with and without the tracer, and the sections as torch.profiler events.

The chained-plan scene is tests/test_torch_capped_plan.py's walled scene.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from test_torch_capped_plan import _inputs
from test_torch_prefilter import CONFIG as JAX_CONFIG
from vk3dgaussiansplatting_tpu_torch import Renderer, RenderConfig, convert
from vk3dgaussiansplatting_tpu_torch import pipeline
from vk3dgaussiansplatting_tpu_torch.parallel import dist as td
from vk3dgaussiansplatting_tpu_torch.parallel import mesh, multihost
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
from vk3dgaussiansplatting_tpu_torch.utils import timing

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=48, capacity_slack_per_tile=16)
CAPPED = dataclasses.replace(CFG, blend_depth_cap=384, blend_cap_max=4096)
FRAME_PASSES = {"keygen", "sort", "ranges", "blend", "quantize"}
CAPPED_PASSES = {"keygen", "sort", "ranges", "layout", "blend", "policy", "patch", "quantize"}


def _scene(config):
    scene = synthetic.SimpleTestGaussiansScene(aspect=config.aspect)
    scene.init()
    scene.camera.set_aspect(config.aspect)
    return scene


def _renderer(config, scene, **kw):
    r = Renderer(config, device="cpu", **kw)
    r.init_for_scene(scene.gaussians())
    return r


def _by_frame(spans):
    out = {}
    for s in spans:
        out.setdefault(s.frame, []).append(s)
    return out


class _FakeEvent:
    """A CUDA event's interface, for counting the pairs a timer records."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_spans_of_a_draw_nest_under_its_frame(monkeypatch):
    scene = _scene(CFG)
    r = _renderer(CFG, scene)
    timer = timing.CudaPassTimer(device_events=False)
    for _ in range(2):
        r.draw(scene.camera, timer=timer)
    frames = _by_frame(timer.spans())
    assert sorted(frames) == [0, 1]
    for spans in frames.values():
        parents = {s.name: s.parent for s in spans}
        assert parents == {"frame": None, "project": "keygen", "depth_order": "keygen",
                           "expand": "keygen", **{name: "frame" for name in FRAME_PASSES}}
        root = next(s for s in spans if s.name == "frame")
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans)
        # Spans close children first, the frame last.
        assert spans[-1] is root
    assert timer.counts()["frame"] == 2 and "sync" not in timer.counts()
    # Outside a frame a span has no frame index.
    with timer.section("loose"):
        pass
    assert timer.spans()[-1].frame is None and timer.spans()[-1].parent is None
    # With CUDA events, every pass gets a pair but the host-only ones, and
    # nothing records a span.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    timer = timing.CudaPassTimer()
    r.draw(scene.camera, timer=timer)
    assert set(timer.totals()) == {"depth_order", "expand"} | FRAME_PASSES - timing.HOST_ONLY
    assert timer.spans() == [] and timer.counts() == {}


def test_self_time_is_duration_less_children():
    timer = timing.CudaPassTimer(device_events=False)
    with timer.section("frame"):
        with timer.section("policy"):
            timing.read_back(timer, torch.tensor([1, 2]))
            with timer.section("inner"):
                sum(range(20000))
        with timer.section("patch"):
            pass
    spans = {s.name: s for s in timer.spans()}
    dur = {n: s.end_ns - s.start_ns for n, s in spans.items()}
    assert spans["policy"].child_ns == dur["sync"] + dur["inner"]
    assert spans["frame"].child_ns == dur["policy"] + dur["patch"]
    assert spans["sync"].parent == "policy" and spans["sync"].child_ns == 0
    for name, s in spans.items():
        assert s.self_ns == dur[name] - s.child_ns >= 0
    # The self times add up to the root's duration.
    assert sum(s.self_ns for s in spans.values()) == dur["frame"]
    assert timing.read_back(None, torch.tensor(True)) is True


@pytest.mark.parametrize("path", ["uncapped", "static_cap", "temporal"])
def test_host_syncs_a_frame_by_path(path):
    config = CFG if path == "uncapped" else CAPPED
    scene = _scene(config)
    timer = timing.CudaPassTimer(device_events=False)
    frames = 3
    if path == "static_cap":
        # The static cap is `render_frame`'s; Renderer's capped frame is
        # the temporal one.
        r = _renderer(config, scene)
        view, proj = scene.camera.matrices()
        for _ in range(frames):
            with timer.section("frame"):
                pipeline.render_frame(r.table, view, proj, scene.camera.position,
                                      config=config, capacity=r.capacity, timer=timer)
    else:
        r = _renderer(config, scene)
        for _ in range(frames):
            r.draw(scene.camera, timer=timer)
    syncs = {f: [s for s in spans if s.name == "sync"]
             for f, spans in _by_frame(timer.spans()).items()}
    assert sorted(syncs) == list(range(frames))
    per_frame = {f: len(v) for f, v in syncs.items()}
    if path == "uncapped":
        assert set(per_frame.values()) == {0}
    elif path == "static_cap":
        assert set(per_frame.values()) == {1}
        assert {s.parent for v in syncs.values() for s in v} == {"blend"}
    else:
        assert min(per_frame.values()) >= 1
        assert {s.parent for v in syncs.values() for s in v} == {"policy"}
        parents = {s.name: s.parent for s in timer.spans()}
        assert {n for n, p in parents.items() if p == "frame"} == CAPPED_PASSES
    assert timer.counts().get("sync", 0) == sum(per_frame.values())


def test_chained_plan_counts_switch_decline_and_revert(monkeypatch):
    monkeypatch.setattr(Renderer, "BIG_SCENE_CAPACITY", 1)
    monkeypatch.setattr(Renderer, "WARMUP_FRAMES", 4)
    table, cam, _jargs, _targs = _inputs()
    config = convert.config_from_jax(JAX_CONFIG)

    def renderer(frac):
        r = Renderer(config, device="cpu", steady_frac=frac)
        r.init_for_scene(convert.table_from_jax(table))
        return r, timing.CudaPassTimer(device_events=False)

    # Declined: the filtered list does not fit 5% of the capacity.
    r, timer = renderer(0.05)
    for _ in range(6):
        r.draw(cam, timer=timer)
    counts = timer.counts()
    assert r._plan.steady_declined and r._plan.mode == "full"
    assert counts.get("steady_declined") == 1
    assert "steady_switch" not in counts and "steady_revert" not in counts
    # The live count's read-back is the switch frame's one extra sync.
    syncs = {f: sum(s.name == "sync" for s in spans)
             for f, spans in _by_frame(timer.spans()).items()}
    assert syncs[4] == syncs[3] + 1

    # Switched; a steady overflow then reverts it at an 8-frame check, and
    # the re-probe declines.
    r, timer = renderer(0.9)
    for _ in range(5):
        r.draw(cam, timer=timer)
    assert r._plan.mode == "steady" and timer.counts().get("steady_switch") == 1
    r._plan.steady_capacity = 512
    for _ in range(24):
        r.draw(cam, timer=timer)
        if r._plan.mode == "full":
            break
    counts = timer.counts()
    assert counts.get("steady_revert") == 1 and "steady_declined" not in counts
    r.draw(cam, timer=timer)
    assert timer.counts().get("steady_declined") == 1 and r._plan.steady_declined


def test_traced_frames_equal_untraced(monkeypatch):
    monkeypatch.setattr(Renderer, "WARMUP_FRAMES", 2)
    for config, big in ((CFG, False), (CAPPED, False), (CAPPED, True)):
        if big:
            monkeypatch.setattr(Renderer, "BIG_SCENE_CAPACITY", 1)
        scene = _scene(config)
        plain, traced = _renderer(config, scene), _renderer(config, scene)
        timer = timing.CudaPassTimer(device_events=False)
        base = scene.camera.position.copy()
        for i in range(5):
            scene.camera.set_position(base + np.float32([1e-3 * i, 0.0, 0.0]))
            a, b = plain.draw(scene.camera), traced.draw(scene.camera, timer=timer)
            assert torch.equal(a.image_u8, b.image_u8) and torch.equal(a.image, b.image)
            assert int(a.num_elements) == int(b.num_elements)
            assert (a.ok is None) == (b.ok is None)
            if a.ok is not None:
                assert bool(a.ok) == bool(b.ok)
        if big:
            assert plain._plan.mode == traced._plan.mode == "steady"
        assert timer.counts()["frame"] == 5


def test_profiler_sees_the_sections():
    scene = _scene(CAPPED)
    r = _renderer(CAPPED, scene)
    timer = timing.CudaPassTimer(device_events=False)
    r.draw(scene.camera, timer=timer)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.draw(scene.camera, timer=timer)
    names = {e.name for e in prof.events()}
    assert {timing.PROFILER_PREFIX + n for n in CAPPED_PASSES | {"frame", "sync"}} <= names
    events = {e.name: e for e in prof.events() if e.name.startswith(timing.PROFILER_PREFIX)}
    frame = events["vk3d/frame"].time_range
    for e in events.values():
        assert frame.start <= e.time_range.start <= e.time_range.end <= frame.end


def test_distributed_frame_is_one_span_tree(tmp_path):
    scene = _scene(CFG)
    multihost.initialize("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        comm = mesh.Communicator("cpu")
        table = td._pad_table(scene.gaussians(), 1)
        frame = td.make_distributed_render(
            comm, CFG, td.plan_distribution(CFG, table.num_gaussians, 1))
        view, proj = scene.camera.matrices()
        timer = timing.CudaPassTimer(device_events=False)
        untraced, dropped = frame(td.shard_table(table, 0, 1), view, proj,
                                  scene.camera.position)
        traced, _ = frame(td.shard_table(table, 0, 1), view, proj, scene.camera.position,
                          timer=timer)
    finally:
        tdist.destroy_process_group()
    assert int(dropped[0]) == 0 and torch.equal(untraced, traced)
    spans = timer.spans()
    assert {s.frame for s in spans} == {0}
    parents = {s.name: s.parent for s in spans}
    assert parents["frame"] is None and parents["expand"] == "keygen"
    assert {"keygen", "bucket", "exchange", "sort", "ranges", "blend"} <= {
        n for n, p in parents.items() if p == "frame"}
    assert [s.parent for s in spans if s.name == "sync"] == ["ranges"]
