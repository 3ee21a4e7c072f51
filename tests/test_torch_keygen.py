"""Port parity: keygen (ops/keygen.py) against the JAX package's jitted
`generate_sort_elements`, with the expansion as `jnp.repeat` and as the
Pallas kernel (interpret mode).  Tile, depth, index and count must be
bit-exact; the frame data is compared with allclose (rtol 1e-5, atol 1e-6),
but for the rgb of gaussians that emit no element, which the port leaves
exactly 0 (no reader looks it up) where JAX evaluates a colour.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda import keygen_kernel as kk
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "gs_export_384.ply"
_jax_keygen = jax.jit(jkg.generate_sort_elements, static_argnames=("config", "capacity"))


def _scene(name):
    """(JAX table, camera, config) for one test scene."""
    if name in ("simple", "sort"):
        config = RenderConfig(width=128, height=128, capacity_slack_per_tile=32,
                              sort_algorithm=SortAlgorithm.XLA_SORT)
        cls = jsyn.SimpleTestGaussiansScene if name == "simple" else jsyn.TestSortScene
        scene = cls(aspect=config.aspect)
        scene.init()
        scene.camera.set_aspect(config.aspect)
        return scene.gaussians(), scene.camera, config
    config = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
    cam = Camera(config.aspect)
    if name == "ply":
        from vk3dgaussiansplatting_tpu.io.ply import load_gaussians

        cam.set_position((0.0, 0.0, 2.5))
        cam.set_rotation(math.pi, 0.0)
        return load_gaussians(FIXTURE), cam, config
    # "cloud<k>": a 2,048-gaussian procedural cloud, scaled so gaussians
    # cover several tiles, seen from camera k.
    k = int(name[len("cloud"):])
    pos, rot = [((0.0, 0.0, 2.0), (math.pi, 0.0)),
                ((0.3, -0.2, 2.5), (3.0, -0.2)),
                ((1.0, 0.5, -3.0), (0.2, 0.1))][k]
    cam.set_position(pos)
    cam.set_rotation(*rot)
    table = jsyn.procedural_cloud_table(2048, seed=11)
    table = dataclasses.replace(table, scale=table.scale * np.float32(6.0))
    return table, cam, config


def _compare(table, cam, config, method, capacity=None):
    config = dataclasses.replace(config, expansion_method=method)
    capacity = capacity or config.sort_capacity(table.position.shape[0])
    view, proj = cam.matrices()
    jt = jax.tree.map(jnp.asarray, table)
    je, jf = _jax_keygen(jt, jnp.asarray(view), jnp.asarray(proj),
                         jnp.asarray(cam.position), config=config, capacity=capacity)
    tt, tcfg = convert.table_from_jax(table), convert.config_from_jax(config)
    te, tf = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity)
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(
            getattr(te, name).numpy(), np.asarray(getattr(je, name)).astype(np.int64), name
        )
    assert int(te.count) == int(je.count)
    # The port evaluates no colour for a gaussian that emits no element (no
    # reader looks it up): its rgb is exactly 0 where JAX's is a colour.
    emits = kk.emitting(kk.project_gaussians_plain(tt, view, proj, cam.position, tcfg,
                                                   capacity)).numpy()
    for name in jf._fields:
        got, want = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        if name == "color_alpha":
            assert (got[~emits, :3] == 0).all(), "rgb of a gaussian that emits nothing"
            got, want = (np.concatenate([a[emits].ravel(), a[~emits, 3]]) for a in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    return te


@pytest.mark.parametrize("method", ["repeat", "pallas"])
@pytest.mark.parametrize("scene", ["simple", "sort", "ply", "cloud0", "cloud1", "cloud2"])
def test_keygen_matches_jax(scene, method):
    table, cam, config = _scene(scene)
    launches = LAUNCHES["expand_rows"]
    te = _compare(table, cam, config, method)
    assert LAUNCHES["expand_rows"] == launches  # CPU tensors: plain version
    count = int(te.count)
    assert count > 0
    # The sentinel tail.
    assert (te.tile[count:] == 0xFFFFFFFF).all() and (te.index[count:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("method", ["repeat", "pallas"])
def test_overflow_drop_at_small_capacity(method):
    table, cam, config = _scene("cloud0")
    view, proj = cam.matrices()
    total = int(tkg.count_live_elements(
        convert.table_from_jax(table), view, proj, cam.position, convert.config_from_jax(config)
    ))
    capacity = total // 2 + 3
    te = _compare(table, cam, config, method, capacity=capacity)
    assert int(te.count) == capacity  # every slot live, the rest dropped


def test_count_live_elements_matches_jax():
    for k in range(3):
        table, cam, config = _scene(f"cloud{k}")
        view, proj = cam.matrices()
        want = int(jax.jit(jkg.count_live_elements, static_argnames=("config",))(
            jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
            jnp.asarray(cam.position), config=config,
        ))
        got = int(tkg.count_live_elements(
            convert.table_from_jax(table), view, proj, cam.position,
            convert.config_from_jax(config),
        ))
        assert got == want > 0
