"""Guards of the port: no JAX at run time, no silent fallbacks, and clear
errors for what is not ported yet."""

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
    r = Renderer(SMALL, device="cpu", use_kernels=True)
    r.init_for_scene(scene.gaussians())
    assert r.draw_numpy(scene.camera)[..., :3].any()
    assert expand_kernel.LAUNCHES == 0
    assert blend_kernel.LAUNCHES == 0


def test_capped_blend_with_kernels_not_ported():
    cfg = RenderConfig(width=64, height=48, blend_depth_cap=256)
    with pytest.raises(NotImplementedError, match="slice 2"):
        Renderer(cfg, device="cpu", use_kernels=True)
    # Kernels off: the uncapped plain blend, as the JAX package does
    # without its Pallas blend.
    assert Renderer(cfg, device="cpu").use_kernels is False


def test_depth_threshold_prefilter_not_ported():
    table = synthetic.simple_test_gaussians_table()
    cam = Camera(SMALL.aspect)
    view, proj = cam.matrices()
    thr = torch.zeros(SMALL.num_tiles, dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        keygen.generate_sort_elements(table, view, proj, cam.position, SMALL, 64, depth_thr=thr)
    with pytest.raises(NotImplementedError):
        keygen.count_live_elements(table, view, proj, cam.position, SMALL, depth_thr=thr)


def test_bitonic_sort_not_ported():
    el = keygen.SortElements(*(torch.zeros(4, dtype=torch.int64) for _ in range(3)),
                             torch.tensor(4))
    with pytest.raises(NotImplementedError, match="A16"):
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
