"""Port parity: the blend K2's plain version (ops/blend.py:blend_rows_plain,
reached through ops/blend.py's entry points on CPU tensors) against the JAX
Pallas `blend_tiles_pallas` (interpret mode) and `blend_tiles_xla`, on the
same sorted elements, ranges and frame data.

Bounds (docs/TOLERANCES.md): float |Δ| <= 2e-3 and 8-bit ±1, each of r, g
and b checked on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import blend as jblend
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel as jbk
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)

CONFIG = RenderConfig(width=128, height=128, capacity_slack_per_tile=32,
                      sort_algorithm=SortAlgorithm.XLA_SORT, expansion_method="repeat")


def _jax_inputs(scene_cls):
    scene = scene_cls(aspect=CONFIG.aspect)
    scene.init()
    scene.camera.set_aspect(CONFIG.aspect)
    table = scene.gaussians()
    view, proj = scene.camera.matrices()
    cap = CONFIG.sort_capacity(table.position.shape[0])

    @jax.jit
    def chain(t, v, p, c):
        el, fr = jkg.generate_sort_elements(t, v, p, c, CONFIG, cap)
        el = jsort.sort_elements(el, CONFIG)
        return el, jranges.find_ranges(el, CONFIG.num_tiles), fr

    return chain(jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
                 jnp.asarray(scene.camera.position))


def _to_torch(el, rg, fr):
    i64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    te = tkg.SortElements(i64(el.tile), i64(el.depth), i64(el.index), i64(el.count))
    tf = tkg.GaussianFrameData(*(torch.from_numpy(np.array(a)) for a in fr))
    return te, i64(rg), tf


def _assert_close(got, want, what):
    assert got.shape == want.shape
    for ch in range(3):
        d = np.abs(got[..., ch] - want[..., ch])
        assert d.max() <= 2e-3, f"{what} channel {ch}: float max |Δ| {d.max()}"
        q = np.abs(np.round(got[..., ch] * 255.0).astype(np.int32)
                   - np.round(want[..., ch] * 255.0).astype(np.int32))
        assert q.max() <= 1, f"{what} channel {ch}: u8 max |Δ| {q.max()}"


@pytest.mark.parametrize("scene", ["simple", "sort"])
def test_plain_blend_matches_jax(scene):
    cls = jsyn.SimpleTestGaussiansScene if scene == "simple" else jsyn.TestSortScene
    el, rg, fr = _jax_inputs(cls)
    want_pallas = np.asarray(jbk.blend_tiles_pallas(el, rg, fr, CONFIG))
    want_xla = np.asarray(jax.jit(jblend.blend_tiles_xla, static_argnames=("config",))(
        el, rg, fr, config=CONFIG))
    te, tr, tf = _to_torch(el, rg, fr)
    launches = LAUNCHES["blend_tiles"]
    got = tblend.blend_tiles(te, tr, tf, convert.config_from_jax(CONFIG)).numpy()
    assert LAUNCHES["blend_tiles"] == launches  # CPU tensors: plain version
    _assert_close(got, want_pallas, "vs blend_tiles_pallas")
    _assert_close(got, want_xla, "vs blend_tiles_xla")
    for ch in range(3):
        assert got[..., ch].mean() > 0, f"channel {ch} is empty"


def test_pack_feature_table_and_gather():
    el, rg, fr = _jax_inputs(jsyn.SimpleTestGaussiansScene)
    te, _tr, tf = _to_torch(el, rg, fr)
    want = np.asarray(jax.jit(jbk.pack_feature_table)(fr))
    np.testing.assert_array_equal(tblend.pack_feature_table(tf).numpy(), want)
    for a, b in zip(tblend.gather_element_features(te, tf),
                    jax.jit(jblend.gather_element_features)(el, fr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantize_and_assemble_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, size=(40, 56, 3)).astype(np.float32)
    img[0, :4, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 254.5 / 255]  # ties
    clipped = np.clip(img, 0, 1)
    np.testing.assert_array_equal(
        tblend.quantize_image(torch.from_numpy(clipped)).numpy(),
        np.asarray(jblend.quantize_image(jnp.asarray(clipped))),
    )
    cfg = RenderConfig(width=40, height=24)
    tiles = rng.uniform(-0.5, 1.5, size=(cfg.num_tiles, 256, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tblend.assemble_tile_colors(torch.from_numpy(tiles), convert.config_from_jax(cfg)).numpy(),
        np.asarray(jblend.assemble_tile_colors(jnp.asarray(tiles), cfg)),
    )


def test_blend_rejects_bad_inputs():
    """blend_tiles (K2) rejects a frame row of the wrong width, int32 ids and
    a short ranges table."""
    cfg = convert.config_from_jax(CONFIG)
    frame = tkg.GaussianFrameData(torch.zeros((4, 4)), torch.zeros((4, 3)), torch.zeros((4, 3)),
                                  torch.zeros((4, 2)))
    index = torch.zeros(8, dtype=torch.int64)
    elements = tkg.SortElements(index, index, index, torch.zeros((), dtype=torch.int64))
    ranges = torch.zeros((cfg.num_tiles, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        tblend.blend_tiles(elements, ranges, frame._replace(color_alpha=frame.color_alpha[:, :3]), cfg)
    with pytest.raises(ValueError):
        tblend.blend_tiles(elements._replace(index=index.to(torch.int32)), ranges, frame, cfg)
    with pytest.raises(ValueError):
        tblend.blend_tiles(elements, ranges[:-1], frame, cfg)
