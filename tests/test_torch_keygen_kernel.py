"""keygen's per-gaussian pass K7 (`keygen_kernel.project_gaussians`,
csrc/keygen.cu) and the expansion that decodes the sort elements in its
store (`expand_kernel.expand_elements`, csrc/expand.cu).

On the CPU the wrappers run their plain versions (`project_gaussians_plain`,
`decode_slots_plain` over `expand_rows_plain`); here they are held, through
the port's `generate_sort_elements` and `count_live_elements`, to the JAX
package's jitted functions: tile, depth, index, count and the live counts
bit for bit, the frame data within test_torch_keygen.py's tolerance (rtol
1e-5, atol 1e-6, NaN equal to NaN; the rgb of a gaussian that emits no
element exactly 0, where JAX evaluates a colour), with and without the prefilter's
thresholds and in the three SH modes, then on the edge cases (behind the
near plane, det == 0, a zero-length view direction, +-inf positions, radii
far off the grid, N = 1, and N = 0 against the empty list). The launchers
refuse CPU tensors and wrong dtypes or shapes with `ValueError`. On the card
(`cuda` marker, skipped without one) K7 and the fused expansion against
their plain versions on the same edge cases: integers bit for bit, floats
within 1 ulp (the plain version's float64 `_fma` is one ulp off on a float32
tie).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SphericalHarmonicsMode
from vk3dgaussiansplatting_tpu.models.gaussians import GaussianTable as JaxTable
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import prefilter
from vk3dgaussiansplatting_tpu_torch.ops.cuda import expand_kernel
from vk3dgaussiansplatting_tpu_torch.ops.cuda import keygen_kernel as kk
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)

CONFIG = RenderConfig(width=128, height=96, capacity_slack_per_tile=32)
_jax_keygen = jax.jit(jkg.generate_sort_elements, static_argnames=("config", "capacity"))
_jax_count = jax.jit(jkg.count_live_elements, static_argnames=("config",))
FIELDS = ("position", "scale", "rot", "sh", "opacity")


def _camera():
    cam = Camera(CONFIG.aspect)
    cam.set_position((0.3, -0.2, 2.5))
    cam.set_rotation(3.0, -0.2)
    return cam


def _cloud(n, seed=11):
    """A procedural cloud scaled so gaussians cover several tiles, with SH
    rest coefficients large enough for every band to count."""
    t = jsyn.procedural_cloud_table(n, seed=seed, sh_rest_std=0.3)
    return {f: np.asarray(getattr(t, f)) * (np.float32(6.0) if f == "scale" else 1)
            for f in FIELDS}


def _world(view, pv):
    """World positions of view-space points [K, 3] (float64 inverse of
    the view transform, rounded to float32)."""
    v = view.astype(np.float64)
    world = (np.asarray(pv, np.float64) - v[:3, 3]) @ np.linalg.inv(v[:3, :3]).T
    return world.astype(np.float32)


def _append(table, pos, scale=None):
    """`table` with gaussians at `pos` [K, 3] (scale 0.05 unless given)."""
    k = len(pos)
    rng = np.random.default_rng(k)
    rot = rng.normal(size=(k, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    extra = {
        "position": np.asarray(pos, np.float32),
        "scale": np.full((k, 3), 0.05, np.float32) if scale is None else np.asarray(scale,
                                                                                    np.float32),
        "rot": rot,
        "sh": rng.normal(0, 0.3, size=(k, 16, 3)).astype(np.float32),
        "opacity": np.full(k, 0.7, np.float32),
    }
    return {f: np.concatenate([table[f], extra[f]]) for f in FIELDS}


def _edge_case(case):
    """(tables, config, camera) of one edge case: a few regular gaussians
    with the case's gaussians appended."""
    cam = _camera()
    view, _ = cam.matrices()
    base = _cloud(32)
    config = CONFIG
    if case == "behind_near":  # view z: in front of the camera .. behind it
        z = [1.0, 0.0, -0.05, -0.0999, -np.float32(CONFIG.near_plane), -0.1001]
        tables = [_append(base, _world(view, [[0.01 * i, 0.02, zi] for i, zi in enumerate(z)]))]
    elif case == "det_zero":  # no dilation: a zero-scale splat has det == 0
        config = dataclasses.replace(CONFIG, covariance_dilation=0.0)
        pos = _world(view, [[0.0, 0.0, -2.0], [0.1, 0.05, -1.5], [-0.2, 0.1, -3.0]])
        tables = [_append(base, pos, scale=[[0, 0, 0], [0, 0, 0], [0.3, 0, 0]])]
    elif case == "nan_dir":  # a gaussian at the camera: normalize(0) is NaN
        tables = [_append(base, [cam.position, cam.position + np.float32([0, 0, 1e-30])])]
    elif case == "inf_pos":
        inf = np.inf
        tables = [_append(base, [[inf, 0, 0], [-inf, 0, 0], [0, inf, 0], [0, 0, -inf],
                                 [inf, -inf, inf]])]
    elif case == "radius_off_grid":  # radii past int32 (saturated, + 1 wrapped) and inf
        pos = _world(view, [[0.0, 0.0, -2.0], [2.4, 0.0, -2.0], [0.0, -1.9, -2.0],
                            [0.5, 0.5, -3.0], [0.1, 0.0, -2.0]])
        tables = [_append(base, pos, scale=[[1e4, 1e4, 1e4], [3.0, 3.0, 3.0], [2.0, 0.1, 2.0],
                                            [1e20, 1e20, 1e20], [1e12, 1e12, 1e12]])]
    elif case == "n0_n1":  # N = 0 has no JAX counterpart (its jnp.repeat fails)
        tables = [_cloud(1)]
    else:
        raise ValueError(case)
    return tables, config, cam


def _thresholds(table, cam, config, seed=3):
    """A [T] depth-threshold map: uint32 keys in the nearest third of the
    cloud's depth keys, one tile SENTINEL (filtering off there)."""
    view, proj = cam.matrices()
    t = convert.table_from_jax(JaxTable(**table))
    p = kk.project_gaussians_plain(t, view, proj, cam.position, config, 1 << 20)
    keys = p.cols[5].to(torch.int64) & 0xFFFFFFFF
    lo, hi = int(keys.min()), int(keys.max()) + 1
    rng = np.random.default_rng(seed)
    thr = rng.integers(lo, lo + (hi - lo) // 3 + 1, size=config.num_tiles, dtype=np.int64)
    thr[rng.integers(config.num_tiles)] = 0xFFFFFFFF
    return thr


def _compare_with_jax(table, config, cam, thr=None):
    view, proj = cam.matrices()
    n = len(table["position"])
    capacity = config.sort_capacity(max(n, 1))
    jt = JaxTable(**{f: jnp.asarray(v) for f, v in table.items()})
    jthr = None if thr is None else jnp.asarray(thr.astype(np.uint32))
    je, jf = _jax_keygen(jt, jnp.asarray(view), jnp.asarray(proj), jnp.asarray(cam.position),
                         config=config, capacity=capacity, depth_thr=jthr)
    tcfg = convert.config_from_jax(config)
    tt = convert.table_from_jax(JaxTable(**table))
    tthr = None if thr is None else torch.from_numpy(thr)
    te, tf = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity, tthr)
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)).astype(np.int64), name)
    assert int(te.count) == int(je.count)
    # The port evaluates no colour for a gaussian that emits no element (no
    # reader looks it up): its rgb is exactly 0 where JAX's is a colour.
    dil = None if tthr is None else prefilter.dilate_thresholds(tthr, tcfg)
    emits = kk.emitting(kk.project_gaussians_plain(tt, view, proj, cam.position, tcfg, capacity,
                                                   dil)).numpy()
    for name in jf._fields:
        got, want = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        if name == "color_alpha":
            assert (got[~emits, :3] == 0).all(), "rgb of a gaussian that emits nothing"
            got, want = (np.concatenate([a[emits].ravel(), a[~emits, 3]]) for a in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True,
                                   err_msg=name)
    want = int(_jax_count(jt, jnp.asarray(view), jnp.asarray(proj), jnp.asarray(cam.position),
                          config=config, depth_thr=jthr))
    assert int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg, tthr)) == want
    return int(te.count)


def test_plain_versions_match_jax():
    """generate_sort_elements and count_live_elements on the CPU (K7's and
    the fused expansion's plain versions) against jitted JAX, with the prefilter unset and
    set, in each SH mode."""
    table = _cloud(512)
    cam = _camera()
    live = []
    for mode, filtered in ((SphericalHarmonicsMode.ALL_BANDS, False),
                           (SphericalHarmonicsMode.ALL_BANDS, True),
                           (SphericalHarmonicsMode.SKIP_FIRST_BAND, True),
                           (SphericalHarmonicsMode.ONLY_FIRST_BAND, False)):
        config = dataclasses.replace(CONFIG, sh_mode=mode)
        thr = _thresholds(table, cam, config) if filtered else None
        live.append(_compare_with_jax(table, config, cam, thr))
    assert live[0] > live[1] > 0  # the thresholds filtered some elements
    assert LAUNCHES["keygen_project"] == LAUNCHES["keygen_count"] == LAUNCHES["expand_rows"] == 0


EDGE_CASES = ("behind_near", "det_zero", "nan_dir", "inf_pos", "radius_off_grid", "n0_n1")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_cases_match_jax(case):
    tables, config, cam = _edge_case(case)
    for table in tables:
        _compare_with_jax(table, config, cam)
    if case == "n0_n1":  # no gaussians: every slot SENTINEL, no live element
        view, proj = cam.matrices()
        empty = convert.table_from_jax(JaxTable(**{f: v[:0] for f, v in tables[0].items()}))
        tcfg = convert.config_from_jax(config)
        el, frame = tkg.generate_sort_elements(empty, view, proj, cam.position, tcfg, 64)
        assert int(el.count) == 0 and (el.tile == 0xFFFFFFFF).all() and frame.cov2d.shape == (0, 3)
        assert int(tkg.count_live_elements(empty, view, proj, cam.position, tcfg)) == 0
    if case == "det_zero":  # the zero-scale splats: alpha zeroed, cov_inv 0
        view, proj = cam.matrices()
        t = convert.table_from_jax(JaxTable(**tables[0]))
        p = kk.project_gaussians_plain(t, view, proj, cam.position,
                                       convert.config_from_jax(config), 4096)
        assert (p.color_alpha[-3:-1, 3] == 0).all() and (p.cov_inv[-3:-1] == 0).all()


def test_launchers_reject_cpu_and_wrong_dtypes():
    cam = _camera()
    view, proj = cam.matrices()
    config = convert.config_from_jax(CONFIG)
    table = convert.table_from_jax(JaxTable(**_cloud(8)))
    with pytest.raises(ValueError, match="device"):
        kk._launch_project(table, view, proj, cam.position, config, 64)
    cols = torch.zeros((6, 16), dtype=torch.int32)
    cum = torch.arange(1, 17, dtype=torch.int64)
    with pytest.raises(ValueError, match="device"):
        expand_kernel._launch_elements("expand_rows", cols, cum, 64, config.grid_width)
    with pytest.raises(ValueError, match="float32"):
        kk.project_gaussians(dataclasses.replace(table, sh=table.sh.double()), view, proj,
                             cam.position, config, 64)
    with pytest.raises(ValueError, match="int64"):
        kk.project_gaussians(table, view, proj, cam.position, config, 64,
                             torch.zeros(config.num_tiles, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        expand_kernel.expand_elements(cols.to(torch.int64), cum, 64, config.grid_width)
    with pytest.raises(ValueError, match="int64"):
        expand_kernel.expand_elements(cols, cum.to(torch.int32), 64, config.grid_width)
    with pytest.raises(ValueError, match="keygen's"):
        expand_kernel.expand_elements(cols[:5], cum, 64, config.grid_width)
    assert LAUNCHES["keygen_project"] == LAUNCHES["keygen_count"] == LAUNCHES["expand_rows"] == 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    """K7 (full and counts mode, with and without thresholds, each SH mode)
    and the fused expansion over K7's rows against their plain versions on
    the card, on every edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7 and K1 are CUDA kernels with no CPU mode")
    for case in EDGE_CASES:
        tables, config, cam = _edge_case(case)
        if case == "n0_n1":
            tables.append({f: v[:0] for f, v in tables[0].items()})
        view, proj = cam.matrices()
        for table in tables:
            t = convert.table_from_jax(JaxTable(**table), device="cuda")
            n = t.num_gaussians
            for mode in SphericalHarmonicsMode:
                tcfg = convert.config_from_jax(dataclasses.replace(config, sh_mode=mode))
                capacity = tcfg.sort_capacity(max(n, 1))
                thr_map = _thresholds(table, cam, config) if n else None
                for thr in (None, thr_map):
                    dil = None if thr is None else prefilter.dilate_thresholds(
                        torch.from_numpy(thr).cuda(), tcfg)
                    for cap in (None, capacity):  # the counts mode, then the full pass
                        args = (t, view, proj, cam.position, tcfg, cap, dil)
                        got = kk.project_gaussians(*args, with_aux=True)
                        want = kk.project_gaussians_plain(*args, with_aux=True)
                        bad = kk.projection_mismatch(got, want)
                        what = f"{case} n={n} {mode.name} thr={thr is not None} cap={cap}"
                        for name, v in bad.items():
                            if name in kk.INT_FIELDS:
                                assert v == 0, f"{what}: {name} differs at {v} values"
                            else:
                                assert v[1] <= 1, f"{what}: {name} {v[0]} values, max ulp {v[1]}"
                    el_args = (got.cols, got.cum, capacity, tcfg.grid_width)
                    for a, b in zip(expand_kernel.expand_elements(*el_args),
                                    expand_kernel.expand_elements_plain(*el_args)):
                        assert torch.equal(a, b), f"{what}: expand_elements differs"
    torch.cuda.synchronize()
