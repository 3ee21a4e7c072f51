"""Port end to end: `Renderer(device="cpu").draw_numpy` against the committed
golden images and against the JAX `render_frame(use_pallas_blend=True)`
(Pallas in interpret mode), within ±1 8-bit step on each of r, g and b."""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu import pipeline as jpipe
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.io import ply as jply
from vk3dgaussiansplatting_tpu.models.gaussians import GaussianTable as JaxGaussianTable
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.models import gaussians as tgauss
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic as tsyn

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
FIXTURE = HERE / "fixtures" / "gs_export_384.ply"
# The configs of tests/test_golden.py:17 and tests/test_ply_fixture.py:26.
CONFIG = RenderConfig(sort_algorithm=SortAlgorithm.XLA_SORT, width=192, height=96,
                      capacity_slack_per_tile=32)


def _ply_table():
    """The port's load transforms on the fixture's raw columns."""
    return tgauss.from_raw_ply_columns(**jply.gaussian_columns_from_ply(FIXTURE))


def _scene(name):
    """(port table, port camera) of a golden scene."""
    cam = Camera(CONFIG.aspect)
    if name == "ply_fixture":
        cam.set_position((0.0, 0.0, 2.5))
        cam.set_rotation(math.pi, 0.0)
        return _ply_table(), cam
    scene = (tsyn.SimpleTestGaussiansScene if name == "simple" else tsyn.TestSortScene)(
        aspect=CONFIG.aspect
    )
    scene.init()
    scene.camera.set_aspect(CONFIG.aspect)
    return scene.gaussians(), scene.camera


def _assert_u8_close(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8
    for ch in range(3):
        d = np.abs(got[..., ch].astype(np.int32) - want[..., ch].astype(np.int32))
        assert d.max() <= 1, f"{what} channel {ch}: max |Δ| {d.max()}"
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("name", ["simple", "sort", "ply_fixture"])
def test_renderer_matches_golden(name):
    from PIL import Image

    table, cam = _scene(name)
    renderer = Renderer(convert.config_from_jax(CONFIG), device="cpu")
    assert renderer.use_kernels is False
    renderer.init_for_scene(table)
    got = renderer.draw_numpy(cam)
    want = np.asarray(Image.open(HERE / "golden" / f"{name}.png"))
    _assert_u8_close(got, want, f"golden {name}")
    for ch in range(3):
        assert got[..., ch].sum() > 0, f"channel {ch} is empty"


@pytest.mark.parametrize("name", ["simple", "ply_fixture"])
def test_renderer_matches_jax_pallas_frame(name):
    table, cam = _scene(name)
    view, proj = cam.matrices()
    jtable = JaxGaussianTable(**{k: jnp.asarray(v) for k, v in table.to_numpy().items()})
    cap = CONFIG.sort_capacity(table.num_gaussians)
    want = jpipe.render_frame(jtable, jnp.asarray(view), jnp.asarray(proj),
                              jnp.asarray(cam.position), config=CONFIG, capacity=cap,
                              use_pallas_blend=True)
    renderer = Renderer(convert.config_from_jax(CONFIG), device="cpu", use_kernels=True)
    renderer.init_for_scene(table)
    out = renderer.draw(cam)
    _assert_u8_close(out.image_u8.numpy(), np.asarray(want.image_u8), f"jax frame {name}")
    assert int(out.num_elements) == int(want.num_elements)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(want.image), atol=2e-3, rtol=0)


def test_ply_load_transforms_match_jax():
    want = jply.load_gaussians(FIXTURE)
    got = _ply_table()
    for name in ("position", "scale", "rot", "sh", "opacity"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_draw_before_init_raises():
    with pytest.raises(RuntimeError):
        Renderer(convert.config_from_jax(CONFIG), device="cpu").draw(Camera())
