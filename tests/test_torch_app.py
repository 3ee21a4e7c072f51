"""Port parity: the app path (CLI, Engine, camera controls, scenes, video,
utilities) against the JAX package on the CPU.

The CLI renders tests/fixtures/gs_export_384.ply as tests/test_ply_fixture.py
does and must land within ±1 8-bit of tests/golden/ply_fixture.png; Engine
frames match JAX's `Engine(use_pallas_blend=False)` within ±1 on r, g and
b; `Camera.update` over a key and mouse sequence, and the surface stand-in
tables for two seeds, are equal to JAX's.  Without CUDA the CLI and Engine
raise unless the CPU is asked for.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.app.engine import Engine as JEngine
from vk3dgaussiansplatting_tpu.app.input import InputState as JInput
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.render.camera import Camera as JCamera
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.app import cli
from vk3dgaussiansplatting_tpu_torch.app.engine import Engine
from vk3dgaussiansplatting_tpu_torch.app.flythrough import render_flythrough
from vk3dgaussiansplatting_tpu_torch.app.input import InputState
from vk3dgaussiansplatting_tpu_torch.io import video
from vk3dgaussiansplatting_tpu_torch.io.image import read_png
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
from vk3dgaussiansplatting_tpu_torch.scenes.scene import Scene, SceneManager
from vk3dgaussiansplatting_tpu_torch.utils import debug, device, timing

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
FIXTURE = TESTS / "fixtures" / "gs_export_384.ply"
JCONFIG = RenderConfig(width=128, height=128, capacity_slack_per_tile=16,
                       sort_algorithm=SortAlgorithm.XLA_SORT)
CONFIG = convert.config_from_jax(JCONFIG)


def test_cli_ply_fixture_matches_golden(tmp_path):
    out = tmp_path / "f.png"
    rc = cli.main([
        "--cpu", "--ply", str(FIXTURE), "--width", "192", "--height", "96", "--slack", "32",
        "--camera", "0", "0", "2.5", repr(math.pi), "0", "--frames", "2", "--no-pallas",
        "--out", str(out),
    ])
    assert rc == 0
    got = read_png(out).astype(np.int32)
    want = read_png(TESTS / "golden" / "ply_fixture.png").astype(np.int32)
    assert got.shape == want.shape == (96, 192, 4)
    assert np.abs(got - want).max() <= 1
    for ch in range(3):
        assert got[..., ch].sum() > 0, f"channel {ch} is empty"


def test_cli_and_engine_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene", "simple", "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(CONFIG)
    assert not (tmp_path / "x.png").exists()
    # --cpu renders without CUDA; the bitonic tier draws the AUTO frame.
    pngs = {}
    for algo in ("auto", "bitonic"):
        pngs[algo] = tmp_path / f"{algo}.png"
        assert cli.main(["--cpu", "--scene", "simple", "--sort", algo, "--width", "64",
                         "--height", "64", "--slack", "16", "--out", str(pngs[algo])]) == 0
    np.testing.assert_array_equal(read_png(pngs["bitonic"]), read_png(pngs["auto"]))
    assert read_png(pngs["auto"])[..., :3].any()


def test_engine_frames_match_jax():
    frames = {}
    for name, eng, scene in (
        ("jax", JEngine(JCONFIG, use_pallas_blend=False), jsyn.SimpleTestGaussiansScene(1.0)),
        ("port", Engine(CONFIG, device="cpu"), synthetic.SimpleTestGaussiansScene(1.0)),
    ):
        eng.init(scene)
        eng.input.set_mouse(True, 40.0, -25.0)  # mouse look: no dt in the step
        eng.input.press("2")
        got = []
        eng.run(2, on_frame=lambda i, img, got=got: got.append(img), log_fps=False)
        assert eng.scene_manager.current.camera.sh_mode.value == 1
        frames[name] = np.stack(got).astype(np.int32)
    assert frames["port"].shape == frames["jax"].shape == (2, 128, 128, 4)
    for ch in range(3):
        assert np.abs(frames["port"][..., ch] - frames["jax"][..., ch]).max() <= 1, f"ch {ch}"
        assert frames["port"][..., ch].sum() > 0
    np.testing.assert_array_equal(frames["port"][0], frames["port"][1])  # look once


def test_camera_update_matches_jax():
    steps = [({"w"}, None, 0.016), ({"w", "shift", "d"}, None, 0.033), ({"e", "a"}, None, 0.1),
             (set(), (12.0, -7.5), 0.0), ({"s", "q", "3"}, (-300.0, 900.0), 0.05),
             ({"1"}, (0.5, 0.25), 0.2)]
    cams = [JCamera(16 / 9), Camera(16 / 9)]
    inputs = [JInput(), InputState()]
    for cam in cams:
        cam.set_position((0.5, -0.25, 2.0))
        cam.set_rotation(2.5, 0.1)
    for keys, mouse, dt in steps:
        for cam, inp in zip(cams, inputs):
            for k in ("w", "a", "s", "d", "q", "e", "shift", "1", "2", "3"):
                (inp.press if k in keys else inp.release)(k)
            inp.set_mouse(mouse is not None, *(mouse or (0.0, 0.0)))
            cam.update(inp, dt)
            inp.end_frame()
        j, t = cams
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.yaw, t.pitch, t.sh_mode.value) == (j.yaw, j.pitch, j.sh_mode.value)
        for a, b in zip(t.matrices(), j.matrices()):
            np.testing.assert_array_equal(a, b)
    cams[1].update(None, 1.0)  # no input: nothing moves
    np.testing.assert_array_equal(cams[1].position, cams[0].position)


class _TableScene(Scene):
    def __init__(self, tables, aspect=1.0):
        super().__init__(aspect)
        self.tables = tables
        self.inits = 0

    def init(self):
        self.inits += 1
        for t in self.tables:
            self.add_gaussians(t)


def test_scene_manager_deferred_switch():
    renderer = Renderer(CONFIG, device="cpu")
    manager = SceneManager(renderer)
    a = _TableScene([synthetic.simple_test_gaussians_table()], aspect=3.0)
    manager.set_scene(a)
    assert manager.current is None and a.inits == 0  # deferred to the next frame
    manager.update_to_next_scene()
    assert manager.current is a and a.inits == 1 and renderer.table.num_gaussians == 16
    assert a.camera.aspect == CONFIG.width / CONFIG.height
    b = _TableScene([synthetic.simple_test_gaussians_table(), synthetic.test_sort_table()])
    b.load_gaussians(str(FIXTURE))
    manager.set_scene(b)
    manager.update()  # updating the current scene does not switch
    assert manager.current is a
    manager.update_to_next_scene()
    manager.update_to_next_scene()  # nothing queued: no re-init
    assert manager.current is b and b.inits == 1 and a.inits == 1
    assert renderer.table.num_gaussians == 384 + 16 + 192
    assert renderer.capacity == CONFIG.sort_capacity(592)


@pytest.mark.parametrize("seed", [0, 7])
def test_procedural_surface_table_matches_jax(seed):
    got = synthetic.procedural_surface_table(3000, seed=seed)
    want = jsyn.procedural_surface_table(3000, seed=seed)
    for f in ("position", "scale", "rot", "sh", "opacity"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    scene = synthetic.ProceduralBenchScene(64, aspect=1.0, seed=seed)
    scene.init()
    np.testing.assert_array_equal(scene.gaussians().position.numpy(),
                                  np.asarray(jsyn.procedural_cloud_table(64, seed=seed).position))


def test_video_writer_png_sequence(tmp_path, monkeypatch):
    renderer = Renderer(CONFIG, device="cpu")
    renderer.init_for_scene(synthetic.simple_test_gaussians_table())
    keys = [((0.0, 0.0, 2.0), math.pi, 0.0), ((0.5, 0.0, 2.5), math.pi - 0.2, 0.1)]
    writer = render_flythrough(renderer, keys, 3)
    assert len(writer.frames) == 3 and writer.frames[0].shape == (128, 128, 3)
    out = writer.save(str(tmp_path / "seq"))
    files = sorted(Path(out).glob("frame_*.png"))
    assert [f.name for f in files] == ["frame_00000.png", "frame_00001.png", "frame_00002.png"]
    for f, frame in zip(files, writer.frames):
        np.testing.assert_array_equal(read_png(f), frame)
    assert not np.array_equal(writer.frames[0], writer.frames[2])
    find_spec = video.importlib.util.find_spec
    monkeypatch.setattr(video.importlib.util, "find_spec",
                        lambda name, *a: None if name == "imageio" else find_spec(name, *a))
    with pytest.raises(RuntimeError, match="imageio"):
        writer.save(str(tmp_path / "clip.mp4"))
    assert not (tmp_path / "clip.mp4").exists() and not (tmp_path / "clip.gif").exists()


def test_utilities_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.device_report()["platform"] == "cpu"
    assert not device.check_suitability(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.CudaPassTimer()
    timing.CudaPassTimer(device_events=False)

    with pytest.raises(FloatingPointError):
        with debug.nan_guard():
            torch.zeros(3) / torch.zeros(3)
    with debug.nan_guard():
        torch.ones(3) / 2
    with debug.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").exists() and prof.key_averages()

    monkeypatch.chdir(tmp_path)
    eng = Engine(CONFIG, device="cpu")
    eng.init(synthetic.SimpleTestGaussiansScene(aspect=1.0))
    eng.input.press("t")  # the memory dump hotkey
    eng.run(1, log_fps=False)
    dump = json.loads((tmp_path / "MemDump.json").read_text())
    assert dump["total_tracked_bytes"] > 0 and dump["arrays"]
    assert not eng.input.is_down("t")
