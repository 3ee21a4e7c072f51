"""Port parity: the depth prefilter (ops/prefilter.py) and keygen's
`depth_thr` branch with the streamed expansion (K1', plain version on CPU
tensors) against the JAX package, bit-exact: dilated thresholds, keep
masks, and the filtered element lists at 3 cameras of the walled scene of
tests/test_prefilter.py:224-249 (rebuilt here in numpy)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.models.gaussians import NUM_SH_COEFFS, GaussianTable
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import prefilter as jpf
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import prefilter as tpf
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)
SENTINEL = 0xFFFFFFFF
# tests/test_prefilter.py's PF_CONFIG: a 16x16 tile grid.
CONFIG = RenderConfig(width=256, height=256, capacity_slack_per_tile=128,
                      sort_algorithm=SortAlgorithm.XLA_SORT, blend_depth_cap=32,
                      blend_cap_max=512, packed_slack_per_tile=512)
CAMERAS = [((0.0, 0.0, 2.0), (math.pi, 0.0)), ((0.3, -0.2, 2.5), (3.0, -0.2)),
           ((-0.4, 0.3, 1.5), (3.3, 0.15))]


def walled_scene(seed=13, n_front=3000, n_back=1500, wall_opacity=0.98):
    """Front cloud + opaque whole-frame wall + back clutter
    (tests/test_prefilter.py:_walled_scene)."""
    rng = np.random.default_rng(seed)

    def layer(n, z0, z1, sfrac, op, spread=1.05):
        z = rng.uniform(z0, z1, n).astype(np.float32)
        u = rng.uniform(-spread, spread, n).astype(np.float32)
        v = rng.uniform(-spread, spread, n).astype(np.float32)
        pos = np.stack([u * (-z), v * (-z), z], axis=1).astype(np.float32)
        scale = (sfrac * (-z))[:, None] * np.ones((1, 3), np.float32)
        return pos, scale.astype(np.float32), np.full(n, op, np.float32)

    parts = [layer(n_front, -3.0, -1.0, 0.06, 0.95),
             layer(20, -3.9, -3.5, 3.0, wall_opacity, spread=0.0),
             layer(n_back, -8.0, -4.5, 0.04, 0.9)]
    pos, scale, op = (np.concatenate(x) for x in zip(*parts))
    n = pos.shape[0]
    sh = np.zeros((n, NUM_SH_COEFFS, 3), np.float32)
    sh[:, 0, :] = rng.uniform(0.2, 1.0, (n, 3))
    return GaussianTable(position=pos, scale=scale,
                         rot=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)), sh=sh,
                         opacity=op)


def thresholds(config, seed=8, high=200_000_000):
    """Threshold keys spanning the scene's depth-key range, a tenth of the
    tiles unfiltered (tests/test_prefilter.py:154-160)."""
    rng = np.random.default_rng(seed)
    thr = rng.integers(0, high, config.num_tiles).astype(np.uint32)
    thr[rng.random(config.num_tiles) < 0.1] = SENTINEL
    return thr


def _camera(k, config=CONFIG):
    cam = Camera(config.aspect)
    pos, rot = CAMERAS[k]
    cam.set_position(pos)
    cam.set_rotation(*rot)
    return cam


def test_dilate_thresholds_matches_jax():
    for seed, cfg in ((5, CONFIG), (6, dataclasses.replace(CONFIG, width=200, height=40))):
        thr = thresholds(cfg, seed=seed, high=2**32 - 1)
        want = jax.jit(jpf.dilate_thresholds, static_argnames=("config", "radius"))(
            jnp.asarray(thr), cfg)
        got = tpf.dilate_thresholds(torch.from_numpy(thr.astype(np.int64)),
                                    convert.config_from_jax(cfg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (tpf.init_thresholds(convert.config_from_jax(CONFIG)) == SENTINEL).all()


def test_keep_mask_matches_jax_with_odd_positions():
    """Random rects and depths, with NaN, ±inf and huge screen positions
    (XLA's saturating float->int cast of screen_pos / 16)."""
    rng = np.random.default_rng(3)
    n = 4000
    sp = rng.uniform(-40, 300, (n, 2)).astype(np.float32)
    sp[:8, 0] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 255.99, 256.0, -0.5]
    sp[8:12, 1] = [np.nan, np.inf, 1e20, -1e20]
    x0 = rng.integers(0, 16, n)
    y0 = rng.integers(0, 16, n)
    ext = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, 6, n), 16),
                    np.minimum(y0 + rng.integers(0, 6, n), 16)], axis=1).astype(np.int32)
    depth = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    dil = jpf.dilate_thresholds(jnp.asarray(thresholds(CONFIG, high=2**32 - 1)), CONFIG)
    want = jax.jit(jpf.gaussian_keep_mask, static_argnames=("config", "radius"))(
        jnp.asarray(sp), jnp.asarray(ext), jnp.asarray(depth), dil, CONFIG)
    got = tpf.gaussian_keep_mask(torch.from_numpy(sp), torch.from_numpy(ext.astype(np.int64)),
                                 torch.from_numpy(depth.astype(np.int64)),
                                 torch.from_numpy(np.asarray(dil).astype(np.int64)),
                                 convert.config_from_jax(CONFIG))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < n


_jax_keygen = jax.jit(jkg.generate_sort_elements, static_argnames=("config", "capacity"))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_filtered_keygen_streamed_matches_jax(k):
    """keygen with a threshold map: JAX's "stream" expansion (Pallas,
    interpret) against the port's streamed expansion, bit-exact; fewer
    elements than unfiltered, and the live count probe agrees."""
    table = walled_scene()
    cam = _camera(k)
    view, proj = cam.matrices()
    cfg = dataclasses.replace(CONFIG, expansion_method="stream")
    capacity = cfg.sort_capacity(table.position.shape[0])
    thr = thresholds(cfg, seed=k)
    jt = jax.tree.map(jnp.asarray, table)
    args = (jt, jnp.asarray(view), jnp.asarray(proj), jnp.asarray(cam.position))
    je, _jf = _jax_keygen(*args, cfg, capacity, depth_thr=jnp.asarray(thr))
    tt, tcfg = convert.table_from_jax(table), convert.config_from_jax(cfg)
    tthr = torch.from_numpy(thr.astype(np.int64))
    launches = (LAUNCHES["expand_rows"], LAUNCHES["expand_rows_streamed"])
    te, _tf = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity, tthr)
    assert (LAUNCHES["expand_rows"], LAUNCHES["expand_rows_streamed"]) == launches
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)).astype(np.int64), name)
    assert int(te.count) == int(je.count)
    full = int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg))
    filt = int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg, depth_thr=tthr))
    want = int(jax.jit(jkg.count_live_elements, static_argnames=("config",))(
        *args, config=cfg, depth_thr=jnp.asarray(thr)))
    assert filt == want == int(te.count) < full


def test_all_sentinel_thresholds_are_a_no_op():
    table = walled_scene(n_front=600, n_back=300)
    cam = _camera(0)
    view, proj = cam.matrices()
    tcfg = convert.config_from_jax(CONFIG)
    tt = convert.table_from_jax(table)
    capacity = tcfg.sort_capacity(tt.num_gaussians)
    plain, _ = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity)
    nop, _ = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity,
                                        tpf.init_thresholds(tcfg))
    for a, b in zip(plain, nop):
        assert torch.equal(a, b)
