"""K7's SH gate (`keygen_kernel.project_gaussians`, csrc/keygen.cu): a
gaussian's SH row is read, and its colour evaluated, only where its emit
count is above 0; everywhere else its rgb is exactly 0 and its alpha kept.

Two tables in front of one camera.  "mixed": a partition (64 rows, K7's
block) in view, two whole partitions behind the near plane, a mixed
partition (in view, behind the camera, in the NDC margin off the image),
a row in view whose tile extents are empty, and a ragged last partition.
"in_view": every row on the image, every row emitting.

On the CPU the plain version's rgb equals the colour of the ungated code
(`render/project.py`'s sh_color) bit for bit where the count is above 0,
and is 0 elsewhere, in the three SH modes; `sh_rows_read` counts the
emitting rows; and `Renderer.draw`'s image equals, bit for bit, the image
blended from the ungated colours (no reader looks up a gaussian without an
element).  On the card (`cuda` marker, skipped without one) K7 against
the plain version on both tables (integers bit for bit, floats within 1
ulp) and the card's image against the ungated colours' image.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu_torch import pipeline
from vk3dgaussiansplatting_tpu_torch.core.config import RenderConfig, SphericalHarmonicsMode
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
from vk3dgaussiansplatting_tpu_torch.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu_torch.ops.cuda import keygen_kernel as kk
from vk3dgaussiansplatting_tpu_torch.render import project
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

CONFIG = RenderConfig(width=128, height=96, capacity_slack_per_tile=32)
BLOCK = 64  # K7's partition: kProjectThreads


def _camera() -> Camera:
    cam = Camera(CONFIG.aspect)
    cam.set_position((0.3, -0.2, 2.5))
    cam.set_rotation(3.0, -0.2)
    return cam


def _points(cam: Camera, ndc, depth) -> np.ndarray:
    """World positions [K, 3] of points at NDC (x, y) [K, 2] and view depth
    -z [K] (negative: behind the camera)."""
    view, proj = cam.matrices()
    ndc, depth = np.asarray(ndc, np.float64), np.asarray(depth, np.float64)
    pv = np.stack([ndc[:, 0] * np.abs(depth) / proj[0, 0],
                   ndc[:, 1] * np.abs(depth) / proj[1, 1], -depth], axis=1)
    v = view.astype(np.float64)
    return ((pv - v[:3, 3]) @ np.linalg.inv(v[:3, :3]).T).astype(np.float32)


def _table(pos: np.ndarray, seed: int) -> GaussianTable:
    """Gaussians at `pos` with small random scales, rotations, SH rows
    (every band large enough to count) and opacities."""
    k = len(pos)
    rng = np.random.default_rng(seed)
    rot = rng.normal(size=(k, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    sh = rng.normal(0.0, 0.3, size=(k, 16, 3)).astype(np.float32)
    sh[:, 0] += 0.8
    return GaussianTable.from_numpy(
        pos, rng.uniform(0.01, 0.05, size=(k, 3)).astype(np.float32), rot, sh,
        rng.uniform(0.3, 0.95, size=k).astype(np.float32))


def _on_image(rng, k):
    return rng.uniform(-0.85, 0.85, size=(k, 2)), rng.uniform(1.0, 4.0, size=k)


def _tables():
    """{name: (table, [N] int emit class)}: 1 on the image, 0 behind the
    near plane, 2 in the NDC margin off the image, 3 in view with empty
    extents (the last two visible but emitting nothing)."""
    cam = _camera()
    rng = np.random.default_rng(29)
    ndc, depth = _on_image(rng, BLOCK)                                 # partition 0: in view
    kinds = [np.ones(BLOCK, int)]
    b_ndc, b_depth = _on_image(rng, 2 * BLOCK)                         # partitions 1-2: behind
    b_depth = np.where(np.arange(2 * BLOCK) % 2, -b_depth, rng.uniform(0.0, 0.09, 2 * BLOCK))
    kinds.append(np.zeros(2 * BLOCK, int))
    m_kind = rng.integers(0, 3, size=BLOCK)                            # partition 3: mixed
    m_ndc, m_depth = _on_image(rng, BLOCK)
    margin = m_kind == 2  # right of the image, inside the NDC limit
    m_ndc[margin, 0] = rng.uniform(1.15, 1.28, size=margin.sum())
    m_depth[margin] = rng.uniform(2.0, 4.0, size=margin.sum())
    m_depth[m_kind == 0] = -m_depth[m_kind == 0]
    kinds.append(m_kind)
    e_ndc, e_depth = np.array([[1.2, 0.0]]), np.array([3.0])           # partition 4, ragged:
    kinds.append(np.array([3]))                                        # in view, empty extents,
    t_ndc, t_depth = _on_image(rng, 21)                                # then 21 on the image
    kinds.append(np.ones(21, int))
    mixed = _points(cam, np.concatenate([ndc, b_ndc, m_ndc, e_ndc, t_ndc]),
                    np.concatenate([depth, b_depth, m_depth, e_depth, t_depth]))
    in_ndc, in_depth = _on_image(rng, 3 * BLOCK + 7)
    return {"mixed": (_table(mixed, 1), np.concatenate(kinds)),
            "in_view": (_table(_points(cam, in_ndc, in_depth), 2), np.ones(3 * BLOCK + 7, int))}


def _ungated_rgb(table: GaussianTable, cam: Camera, mode) -> torch.Tensor:
    """The colour of every gaussian as the code before the gate computed it."""
    cam_pos = torch.as_tensor(np.asarray(cam.position, np.float32), device=table.position.device)
    return project.sh_color(project.normalize_dirs(table.position - cam_pos[None, :]), table.sh,
                            mode)


def _project(table, cam, config, plain=True):
    view, proj = cam.matrices()
    fn = kk.project_gaussians_plain if plain else kk.project_gaussians
    return fn(table, view, proj, cam.position, config,
              config.sort_capacity(max(table.num_gaussians, 1)), with_aux=True)


@pytest.mark.parametrize("mode", list(SphericalHarmonicsMode))
def test_plain_rgb_is_zero_where_nothing_is_emitted(mode):
    config = dataclasses.replace(CONFIG, sh_mode=mode)
    cam = _camera()
    for name, (table, kind) in _tables().items():
        p = _project(table, cam, config)
        emits = kk.emitting(p)
        # The tables hold what they say.
        assert torch.equal(emits, torch.from_numpy(kind == 1)), name
        visible = (p.flags & 1).bool()
        assert torch.equal(visible, torch.from_numpy(kind >= 1)), name
        if name == "mixed":
            assert not emits[BLOCK:3 * BLOCK].any()  # two whole partitions emit nothing
            part = torch.from_numpy(kind[3 * BLOCK:4 * BLOCK])
            assert {0, 1, 2} <= set(part.tolist())
            ext = p.extents[4 * BLOCK]
            assert (ext[2] - ext[0]) * (ext[3] - ext[1]) == 0  # in view, empty extents
        rgb = p.color_alpha[:, :3]
        ungated = _ungated_rgb(table, cam, mode)
        assert torch.equal(rgb[emits], ungated[emits]), name
        assert (rgb[~emits] == 0).all(), name
        assert bool((ungated[~emits] != 0).any()) == (name == "mixed")  # the gate removed colours
        assert torch.equal(p.color_alpha[:, 3], torch.where(
            project._fma(p.cov2d[:, 0], p.cov2d[:, 2], -(p.cov2d[:, 1] * p.cov2d[:, 1])) != 0,
            table.opacity, 0.0)), name


def test_sh_rows_read_counts_the_emitting_rows():
    cam = _camera()
    tables = _tables()
    table, kind = tables["mixed"]
    p = _project(table, cam, CONFIG)
    assert kk.sh_rows_read(p) == int((kind == 1).sum()) == BLOCK + (kind[3 * BLOCK:] == 1).sum()
    table, _ = tables["in_view"]
    assert kk.sh_rows_read(_project(table, cam, CONFIG)) == table.num_gaussians
    empty = GaussianTable(*(getattr(table, f.name)[:0] for f in dataclasses.fields(GaussianTable)))
    assert kk.sh_rows_read(_project(empty, cam, CONFIG)) == 0


def _image_pair(table, cam, config, device):
    """(Renderer.draw's image, the image K2 or its plain version blends from
    the same frame with every gaussian's ungated colour)."""
    r = pipeline.Renderer(config, device=device)
    r.init_for_scene(table)
    image = r.draw(cam).image
    view, proj = cam.matrices()
    elements, ranges, frame = pipeline._sorted_frame(r.table, view, proj, cam.position, config,
                                                     r.capacity, None, reads_depth=False)
    emits = kk.emitting(_project(r.table, cam, config, plain=device == "cpu"))
    rgb = torch.where(emits[:, None], frame.color_alpha[:, :3],
                      _ungated_rgb(r.table, cam, config.sh_mode))
    ungated = frame._replace(color_alpha=torch.cat([rgb, frame.color_alpha[:, 3:]], 1))
    assert torch.equal(ungated.color_alpha, frame.color_alpha) == bool(emits.all())
    return image, blend_ops.blend_tiles(elements, ranges, ungated, config)


def test_image_ignores_the_gated_colours():
    cam = _camera()
    table, _ = _tables()["mixed"]
    image, want = _image_pair(table, cam, CONFIG, "cpu")
    assert image.abs().sum() > 0
    assert torch.equal(image, want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7 is a CUDA kernel with no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_gate_tables():
    _card()
    cam = _camera()
    for name, (table, kind) in _tables().items():
        t = table.to("cuda")
        for mode in SphericalHarmonicsMode:
            config = dataclasses.replace(CONFIG, sh_mode=mode)
            got, want = _project(t, cam, config, plain=False), _project(t, cam, config)
            for field, v in kk.projection_mismatch(got, want).items():
                what = f"{name} {mode.name}: {field}"
                if field in kk.INT_FIELDS:
                    assert v == 0, f"{what} differs at {v} values"
                else:
                    assert v[1] <= 1, f"{what}: {v[0]} values, max ulp {v[1]}"
            emits = kk.emitting(got)
            assert (got.color_alpha[~emits, :3] == 0).all(), name
            assert kk.sh_rows_read(got) == int((kind == 1).sum()), name
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_image_ignores_the_gated_colours():
    _card()
    cam = _camera()
    for name, (table, _) in _tables().items():
        image, want = _image_pair(table, cam, CONFIG, "cuda")
        assert image.abs().sum() > 0 and torch.equal(image, want), name
