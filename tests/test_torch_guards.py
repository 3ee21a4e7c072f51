"""Guards of the port: no JAX at run time, no silent fallbacks, and clear
errors for input the port does not take.  The capped path's own guards are
in tests/test_torch_capped_plan.py."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu_torch.ops import keygen, sort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build, blend_kernel, expand_kernel
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = RenderConfig(width=64, height=48, capacity_slack_per_tile=16)


def test_port_renders_without_jax():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["vk3dgaussiansplatting_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from vk3dgaussiansplatting_tpu_torch import Renderer, RenderConfig
        from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
        cfg = RenderConfig(width=64, height=48, capacity_slack_per_tile=16)
        scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
        scene.init()
        r = Renderer(cfg, device="cpu")
        r.init_for_scene(scene.gaussians())
        img = r.draw_numpy(scene.camera)
        assert img.shape == (48, 64, 4) and img[..., :3].any()
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_cuda_renderer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(SMALL, device="cuda")


def test_wrappers_take_plain_versions_on_cpu():
    counts = torch.tensor([2, 0, 3], dtype=torch.int32)
    cols = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    out, total = expand_kernel.expand_rows(cols, counts, 8)
    assert out.tolist() == [[0, 0, 2, 2, 2, 0, 0, 0], [3, 3, 5, 5, 5, 0, 0, 0]]
    assert int(total) == 5

    scene = synthetic.SimpleTestGaussiansScene(aspect=SMALL.aspect)
    scene.init()
    r = Renderer(SMALL, device="cpu")
    r.init_for_scene(scene.gaussians())
    assert r.draw_numpy(scene.camera)[..., :3].any()
    assert expand_kernel.LAUNCHES == 0
    assert blend_kernel.LAUNCHES == 0


def test_capped_blend_with_kernels_not_ported():
    """`blend_depth_cap > 0` was refused while the capped kernels were
    unported (hence the name); it now selects the capped path, whose kernel
    wrappers run their plain versions on CPU tensors."""
    cfg = RenderConfig(width=64, height=48, capacity_slack_per_tile=16, blend_depth_cap=256)
    scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
    scene.init()
    launches = blend_kernel.FLAT_LAUNCHES
    r = Renderer(cfg, device="cpu")
    assert r.temporal_caps
    r.init_for_scene(scene.gaussians())
    for _ in range(2):
        out = r.draw(scene.camera)
        assert out.ok is not None and bool(out.ok)  # the capped path's flag
        assert out.image_u8[..., :3].any()
        assert r._caps is not None and r._plan is None
    assert blend_kernel.FLAT_LAUNCHES == launches


def test_depth_threshold_prefilter_not_ported():
    """Keygen refused a depth-threshold map while the prefilter was unported
    (hence the name); an all-SENTINEL map is now a no-op and an all-zero map
    drops every coverable gaussian."""
    scene = synthetic.SimpleTestGaussiansScene(aspect=SMALL.aspect)
    scene.init()
    table, cam = scene.gaussians(), scene.camera
    view, proj = cam.matrices()
    full = int(keygen.count_live_elements(table, view, proj, cam.position, SMALL))
    thr = torch.full((SMALL.num_tiles,), 0xFFFFFFFF, dtype=torch.int64)
    el, _ = keygen.generate_sort_elements(table, view, proj, cam.position, SMALL, 64,
                                          depth_thr=thr)
    assert 0 < int(el.count) == min(full, 64)
    zero = torch.zeros(SMALL.num_tiles, dtype=torch.int64)
    assert int(keygen.count_live_elements(table, view, proj, cam.position, SMALL,
                                          depth_thr=zero)) < full


def test_no_handler_catches_kernel_errors():
    """No module of the port, and not chip_smoke.py, catches an exception:
    a failed build or launch always reaches the caller."""
    files = sorted((REPO / "vk3dgaussiansplatting_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text())
        handlers = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{path.relative_to(REPO)} catches exceptions at lines {handlers}"


def test_bitonic_sort_not_ported():
    """The dispatch raised for BITONIC while the tier was unported (hence
    the name); it now reaches the tier, whose power-of-two guard raises."""
    el = keygen.SortElements(*(torch.zeros(6, dtype=torch.int64) for _ in range(3)),
                             torch.tensor(6))
    with pytest.raises(ValueError, match="power-of-two capacity, got 6"):
        sort.sort_elements(el, RenderConfig(sort_algorithm=SortAlgorithm.BITONIC))


def test_unknown_expansion_method_rejected():
    table = synthetic.simple_test_gaussians_table()
    cam = Camera(SMALL.aspect)
    view, proj = cam.matrices()
    cfg = RenderConfig(width=64, height=48, expansion_method="bogus")
    with pytest.raises(ValueError):
        keygen.generate_sort_elements(table, view, proj, cam.position, cfg, 64)


def _isolate_build(monkeypatch, tmp_path, cuda_home):
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path, tmp_path / "empty-cuda")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    assert _build._lib is None


def test_build_reports_compiler_errors(monkeypatch, tmp_path):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: deliberate test failure' >&2\nexit 2\n")
    fake.chmod(0o755)
    _isolate_build(monkeypatch, tmp_path, tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="deliberate test failure"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_path_tracks_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    first = _build.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
