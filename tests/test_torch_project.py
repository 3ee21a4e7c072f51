"""Port parity: projection math (render/project.py) and the procedural scene
generators against the JAX package.

JAX runs jitted, as its frame does (`render_frame` is one jit): XLA then
rewrites division by a constant into a reciprocal multiply and contracts
multiply-adds, which the port reproduces, so integer results are compared
bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SphericalHarmonicsMode
from vk3dgaussiansplatting_tpu.render import project as jproj
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.render import camera as tcam
from vk3dgaussiansplatting_tpu_torch.render import project as tproj
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic as tsyn

torch.set_num_threads(1)

CAMERAS = [
    ((0.0, 0.0, 2.0), (math.pi, 0.0)),
    ((0.3, -0.2, 2.5), (3.0, -0.2)),
    ((1.0, 0.5, -3.0), (0.2, 0.1)),
]


def _cloud(n=2048, seed=5):
    return jsyn.procedural_cloud_table(n, seed=seed)


def _cam(pos, rot, aspect):
    cam = Camera(aspect)
    cam.set_position(pos)
    cam.set_rotation(*rot)
    return cam


@pytest.mark.parametrize("pos,rot", CAMERAS)
def test_depth_keys_and_extents_bit_exact(pos, rot):
    config = RenderConfig(width=256, height=144)
    tconfig = convert.config_from_jax(config)
    table = _cloud()
    view, proj = _cam(pos, rot, config.aspect).matrices()

    @jax.jit
    def jax_keys(position, scale, rot_q):
        pv = jproj.view_transform(position, jnp.asarray(view))
        cov = jproj.compute_cov2d(scale, rot_q, pv, jnp.asarray(view), config)
        sp = jproj.screen_space_position(pv, jnp.asarray(proj), config)
        return (
            jproj.depth_key(pv[:, 2], config),
            jproj.tile_extents(sp, cov, config),
            cov,
            sp,
        )

    jd, je, jc, js = (
        np.asarray(a) for a in jax_keys(table.position, table.scale, table.rot)
    )
    tt = convert.table_from_jax(table)
    pv = tproj.view_transform(tt.position, view)
    cov = tproj.compute_cov2d(tt.scale, tt.rot, pv, view, tconfig)
    sp = tproj.screen_space_position(pv, proj, tconfig)
    np.testing.assert_array_equal(tproj.depth_key(pv[:, 2], tconfig).numpy(), jd.astype(np.int64))
    np.testing.assert_array_equal(tproj.tile_extents(sp, cov, tconfig).numpy(), je)
    # Float intermediates within the JAX tests' own tolerances
    # (tests/test_project.py:66,81).
    np.testing.assert_allclose(cov.numpy(), jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp.numpy(), js, rtol=1e-5, atol=1e-3)


def test_depth_key_saturation():
    config = RenderConfig()
    z = np.array(
        [-1000.0, -config.near_plane - 1e-5, -50.0, -100.0, -99.9999, -0.1, 0.5, -np.inf],
        np.float32,
    )
    want = np.asarray(jax.jit(lambda z: jproj.depth_key(z, config))(z)).astype(np.int64)
    got = tproj.depth_key(torch.from_numpy(z), convert.config_from_jax(config)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0xFFFFFFFF


def test_tile_extents_inf_and_huge_radius():
    """XLA saturates float->int32 and the `+ 1` wraps: the port reproduces
    both on any backend (an x86 cast would give INT_MIN for +inf)."""
    config = RenderConfig(width=256, height=144)
    big = np.float32(3e38)
    screen = np.array(
        [[10.0, 20.0], [100.0, 50.0], [-5.0, 7.0], [3e9, 4.0], [120.0, -3e9],
         [50.0, 60.0], [np.nan, 3.0], [255.9, 143.9], [-4.0, 32.0]],
        np.float32,
    )
    cov = np.array(
        [[np.inf, 0.0, 1.0], [big, 0.0, big], [4.0, 0.0, 4.0], [1.0, 0.0, 1.0],
         [9.0, 1.0, 9.0], [1e12, 5e11, 1e12], [2.0, 0.0, 2.0], [1e-3, 0.0, 1e-3],
         [(5.0 / 3.0) ** 2, 0.0, (5.0 / 3.0) ** 2]],
        np.float32,
    )
    want = np.asarray(
        jax.jit(lambda s, c: jproj.tile_extents(s, c, config))(screen, cov)
    )
    got = tproj.tile_extents(
        torch.from_numpy(screen), torch.from_numpy(cov), convert.config_from_jax(config)
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_sh_color_modes_within_tolerance():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    sh = rng.normal(0, 0.3, size=(256, 16, 3)).astype(np.float32)
    for mode in SphericalHarmonicsMode:
        want = np.asarray(jax.jit(lambda d, s: jproj.sh_color(d, s, mode))(d, sh))
        got = tproj.sh_color(
            torch.from_numpy(d), torch.from_numpy(sh), tproj.SphericalHarmonicsMode(int(mode))
        ).numpy()
        # tests/test_project.py:115
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert (got >= 0).all()
    np.testing.assert_allclose(
        tproj.sh_basis16(torch.from_numpy(d)).numpy(),
        np.asarray(jax.jit(jproj.sh_basis16)(d)),
        rtol=1e-5,
        atol=1e-6,
    )


def test_cameras_match():
    for pos, rot in CAMERAS:
        j = _cam(pos, rot, 16 / 9)
        t = tcam.Camera(16 / 9)
        t.set_position(pos)
        t.set_rotation(*rot)
        for a, b in zip(j.matrices(), t.matrices()):
            np.testing.assert_array_equal(a, b)
    from vk3dgaussiansplatting_tpu.render import camera as jcam

    for name in ("garden", "train", "bicycle"):
        a = getattr(jcam, f"{name}_benchmark_camera")(16 / 9).matrices()
        b = getattr(tcam, f"{name}_benchmark_camera")(16 / 9).matrices()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.simple_test_gaussians_table(),
        lambda m: m.test_sort_table(),
        lambda m: m.procedural_cloud_table(3000, seed=42),
        lambda m: m.procedural_cloud_table(1000, seed=7, opacity_mode="translucent"),
    ],
)
def test_generators_array_equal(make):
    j = make(jsyn)
    t = make(tsyn)
    for name in ("position", "scale", "rot", "sh", "opacity"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
