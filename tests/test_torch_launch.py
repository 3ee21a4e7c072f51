"""The seam between the ops and their CUDA kernels (ops/cuda/_build.py).

(i) Each entry point that chooses between a kernel and its plain twin runs
the twin on CPU tensors, loads no library and counts no launch.  (ii) The
choice (`_build.on_card`), `_build.card_device` and every wrapper that only
launches raise for a `meta` tensor, and so does every entry point.  (iii)
No module under ops/cuda/ imports a module that imports ops/cuda, read from
the sources' import lines.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL, RenderConfig
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
from vk3dgaussiansplatting_tpu_torch.ops import bitonic, blend, sort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import (
    _build, bitonic_kernel, blend_kernel, compact_kernel, expand_kernel, keygen_kernel,
    radix_kernel,
)
from vk3dgaussiansplatting_tpu_torch.ops.keygen import GaussianFrameData, SortElements
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

PKG = Path(_build.__file__).resolve().parents[2]
CONFIG = RenderConfig(width=32, height=32)  # 2 x 2 tiles
N, E = 8, 16


def _i64(values, dev):
    return torch.tensor(values, dtype=torch.int64).to(dev)


def _elements(dev) -> SortElements:
    g = torch.Generator().manual_seed(0)
    tile = torch.randint(0, CONFIG.num_tiles, (E,), generator=g)
    tile[-3:] = SENTINEL
    depth = torch.randint(0, 2**32, (E,), generator=g)
    depth[-3:] = SENTINEL
    index = torch.randint(0, N, (E,), generator=g)
    index[-3:] = SENTINEL
    return SortElements(tile.to(dev), depth.to(dev), index.to(dev), _i64(E - 3, dev))


def _frame(dev) -> GaussianFrameData:
    g = torch.Generator().manual_seed(1)
    screen_pos = torch.rand((N, 2), generator=g) * 32
    cov = torch.tensor([0.05, 0.0, 0.05]).repeat(N, 1)
    color_alpha = torch.rand((N, 4), generator=g)
    return GaussianFrameData(color_alpha.to(dev), cov.to(dev), cov.to(dev), screen_pos.to(dev))


def _table(dev) -> GaussianTable:
    g = torch.Generator().manual_seed(2)
    position = torch.rand((N, 3), generator=g) - 0.5
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(N, 1)
    return GaussianTable(position.to(dev), torch.full((N, 3), 0.05).to(dev), rot.to(dev),
                         (torch.rand((N, 16, 3), generator=g) * 0.1).to(dev),
                         torch.full((N,), 0.5).to(dev))


def _camera_args():
    cam = Camera(CONFIG.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(np.pi, 0.0)
    view, proj = cam.matrices()
    return view, proj, cam.position


def _calls(module, dev):
    """(entry point, its plain twin's name in `home`, arguments) of each
    entry point `module` names, on `dev` tensors; `home` is the module that
    holds the twin and makes the choice."""
    el, frame = _elements(dev), _frame(dev)
    ranges = _i64([[0, 4], [4, 9], [9, 9], [9, 13]], dev)
    cols = torch.arange(6, dtype=torch.int32).reshape(2, 3).to(dev)
    cum = _i64([2, 2, 5], dev)
    src = torch.arange(300, dtype=torch.int64).to(dev)
    starts, counts = _i64([0, 130], dev), _i64([10, 20], dev)
    slabs = (_i64([0, 128], dev), _i64([128, 128], dev), _i64([0, 2], dev), counts)
    carry = (torch.zeros((2, 256, 3)).to(dev), torch.zeros((2, 256)).to(dev))
    strip = dict(tile_base=1, carry_color=carry[0], carry_logt=carry[1])
    table = torch.zeros((N, blend_kernel.NUM_TABLE_COLS)).to(dev)
    return {
        "expand": (expand_kernel, [
            (expand_kernel.expand_rows, "expand_rows_plain", (cols, cum, 8), {}),
            (expand_kernel.expand_rows_streamed, "expand_rows_plain", (cols, cum, 8), {}),
            (expand_kernel.expand_elements, "expand_elements_plain",
             (cols.repeat(3, 1), cum, 8, CONFIG.grid_width), {"streamed": True}),
        ]),
        "keygen": (keygen_kernel, [
            (keygen_kernel.project_gaussians, "project_gaussians_plain",
             (_table(dev), *_camera_args(), CONFIG, 64), {}),
        ]),
        "compact": (compact_kernel, [
            (compact_kernel.compact_runs, "compact_runs_plain",
             (src, starts, slabs[0], 256, 128), {}),
            (compact_kernel.compact_slabs, "compact_slabs_plain", (src, starts, *slabs, 256), {}),
            (compact_kernel.compact_segments, "compact_segments_plain",
             (src, _i64([0, 128], dev), 256), {}),
        ]),
        "sort": (sort, [(sort.sort_elements_xla, "sort_elements_radix_plain",
                         (el, CONFIG.num_tiles), {}),
                        (sort.sort_elements_xla, "sort_elements_radix_plain",
                         (el, CONFIG.num_tiles), {"key": "tile"})]),
        "radix": (radix_kernel, [(radix_kernel.depth_order, "depth_order_plain",
                                  (cols.repeat(3, 1), cum, 8, CONFIG.grid_width,
                                   CONFIG.grid_height), {})]),
        "bitonic": (bitonic, [(bitonic.sort_elements_bitonic, "sort_elements_bitonic_plain",
                               (el,), {})]),
        "blend": (blend, [
            (blend.blend_tiles, "blend_rows_plain", (el, ranges, frame, CONFIG), {}),
            (blend.blend_flat, "blend_flat_plain", (frame, el.index, ranges, CONFIG),
             {"with_t": True}),
            (blend.blend_strip, "blend_strip_plain", (table, el.index, ranges[1:3], CONFIG),
             {**strip, "gather": True}),
        ]),
    }[module]


@pytest.mark.parametrize("module", ["expand", "keygen", "compact", "sort", "radix", "bitonic",
                                    "blend"])
def test_cpu_tensors_run_the_plain_twin(module, monkeypatch):
    home, calls = _calls(module, "cpu")

    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    counts = _build.LAUNCHES.copy()
    for entry, twin, args, kwargs in calls:
        seen = []
        real = getattr(home, twin)

        def spy(*a, _real=real, **k):
            seen.append(_real(*a, **k))
            return seen[-1]

        monkeypatch.setattr(home, twin, spy)
        out = entry(*args, **kwargs)
        monkeypatch.setattr(home, twin, real)
        assert seen and out is seen[-1], f"{entry.__name__} did not return {twin}'s result"
    assert _build.LAUNCHES == counts


def test_meta_tensors_raise():
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        _build.on_card(meta)
    with pytest.raises(ValueError, match="one device"):
        _build.on_card(torch.zeros(8), meta)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            _build.card_device(torch.zeros(8, device=dev))
    assert _build.on_card(torch.zeros(8), None) is False
    el, frame = _elements("meta"), _frame("meta")
    ranges = _i64([[0, 4]] * CONFIG.num_tiles, "meta")
    carry = dict(carry_color=torch.zeros((4, 256, 3), device="meta"),
                 carry_logt=torch.zeros((4, 256), device="meta"))
    card_only = [
        lambda: radix_kernel.radix_sort(*el, CONFIG.num_tiles),
        lambda: bitonic_kernel.bitonic_sort(*el[:3]),
        lambda: blend_kernel.blend_tiles(frame, el.index, ranges, CONFIG),
        lambda: blend_kernel.blend_flat(frame, el.index, ranges, CONFIG),
        lambda: blend_kernel.blend_strip(torch.zeros((E, 10), device="meta"), el.index, ranges,
                                         CONFIG, tile_base=0, **carry),
        lambda: expand_kernel._launch("expand_rows", *_calls("expand", "meta")[1][0][2]),
        lambda: keygen_kernel._launch_project(*_calls("keygen", "meta")[1][0][2]),
        lambda: expand_kernel._launch_elements("expand_rows", *_calls("expand", "meta")[1][2][2]),
        lambda: radix_kernel._launch_depth_order(*_calls("radix", "meta")[1][0][2]),
    ]
    entries = [lambda e=entry, a=args, k=kwargs: e(*a, **k)
               for module in ("expand", "keygen", "compact", "sort", "radix", "bitonic", "blend")
               for entry, _twin, args, kwargs in _calls(module, "meta")[1]]
    for call in card_only + entries:
        with pytest.raises(ValueError, match="unsupported device meta"):
            call()


def _module_of(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _path_of(module: str) -> Path | None:
    base = PKG.parent.joinpath(*module.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def _imports(module: str) -> set[str]:
    """The package's modules that `module`'s import lines name."""
    path = _path_of(module)
    package = module if path.name == "__init__.py" else module.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(anchor + ([node.module] if node.module else []))
            subs = [f"{base}.{a.name}" for a in node.names]
            names = [s for s in subs if _path_of(s)]
            if len(names) < len(subs):  # a name defined in `base` itself
                names.append(base)
        else:
            continue
        out.update(n for n in names if n.split(".")[0] == PKG.name and _path_of(n))
    return out


def test_kernel_layer_imports_no_op_above_it():
    cuda = f"{PKG.name}.ops.cuda"
    for path in sorted((PKG / "ops" / "cuda").glob("*.py")):
        for dep in _imports(_module_of(path)) - {cuda}:
            if dep.startswith(cuda + "."):
                continue
            seen, todo = set(), [dep]
            while todo:
                mod = todo.pop()
                if mod in seen:
                    continue
                seen.add(mod)
                for m in _imports(mod):
                    assert not m.startswith(cuda), (
                        f"{path.name} imports {dep}, which reaches {m} through {mod}")
                    todo.append(m)
