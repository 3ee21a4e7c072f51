"""Port parity: the capped blend (ops/capped.py, K1/K5/K3 plain versions)
against the JAX package's ops/capped.py (Pallas in interpret mode), on the
same sorted elements, ranges and frame data from numpy-built scenes.

Bounds: packed layouts, caps/thresholds/floors, ok flags and stats are
bit-exact; T per pixel at rtol 1e-4 (the port multiplies T sequentially,
JAX by a per-batch cumprod tree), and below float32's smallest normal
(1.2e-38) absolutely, since XLA on the CPU flushes subnormals to zero where
torch keeps them (every policy threshold is above 6e-7); images float |Δ| <= 2e-3 and 8-bit ±1 on
each of r, g and b (docs/TOLERANCES.md).  The JAX capped path carries rgb
as float16 (its narrow gather tables); the port gathers float32 rows, and
`test_f16_rgb_delta` measures what that changes, with the float16 rows
rebuilt here (`pack_feature_tables2`, `rows_from_tables2`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.models.gaussians import NUM_SH_COEFFS, GaussianTable
from vk3dgaussiansplatting_tpu.ops import capped as jcap
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel as jbk
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import capped as tcap
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES

torch.set_num_threads(1)

# The configs of tests/test_capped.py.
BASE = RenderConfig(width=64, height=64, capacity_slack_per_tile=64,
                    sort_algorithm=SortAlgorithm.XLA_SORT, blend_depth_cap=8)
TEMPORAL = dataclasses.replace(BASE, blend_cap_max=64)
DEEP = dataclasses.replace(BASE, blend_depth_cap=32, blend_cap_max=512,
                           capacity_slack_per_tile=512)
FLOAT_TOL = 2e-3
T_RTOL = 1e-4
T_ATOL = float(np.finfo(np.float32).tiny)

_jit_layout = jax.jit(jcap.capped_layout, static_argnames=("config",))
_jit_flat = jax.jit(jbk.blend_flat_core, static_argnames=("config", "capacity", "cap", "with_t"))
_jit_temporal = jcap.blend_tiles_capped_temporal
_jit_split = jcap.blend_tiles_capped_split


def stacked_table(n, opacity, spread=0.0):
    """n frame-covering gaussians stacked in depth (tests/test_capped.py)."""
    rng = np.random.default_rng(9)
    z = np.linspace(-1.0, -3.0, n).astype(np.float32)
    position = np.stack([rng.uniform(-spread, spread, n).astype(np.float32),
                         rng.uniform(-spread, spread, n).astype(np.float32), z], axis=1)
    sh = np.zeros((n, NUM_SH_COEFFS, 3), np.float32)
    sh[:, 0, :] = rng.uniform(0.2, 1.0, (n, 3))
    return GaussianTable(position=position, scale=np.full((n, 3), 2.0, np.float32),
                         rot=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)), sh=sh,
                         opacity=np.full(n, opacity, np.float32))


def cloud_table(n, seed=3):
    """Scattered cloud with varied rects (tests/test_prefilter.py)."""
    rng = np.random.default_rng(seed)
    position = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                         rng.uniform(-4.0, -0.5, n)], axis=1).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sh = np.zeros((n, NUM_SH_COEFFS, 3), np.float32)
    sh[:, 0, :] = rng.uniform(0.2, 1.0, (n, 3))
    return GaussianTable(position=position,
                         scale=np.exp(rng.normal(-2.2, 0.7, (n, 3))).astype(np.float32),
                         rot=q.astype(np.float32), sh=sh,
                         opacity=rng.uniform(0.4, 0.95, n).astype(np.float32))


def prepare(table, config):
    """JAX keygen -> sort -> ranges at the tests' camera; returns the JAX
    (elements, ranges, frame) and the same as port tensors."""
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(np.pi, 0.0)
    view, proj = cam.matrices()
    capacity = config.sort_capacity(int(table.position.shape[0]))

    @jax.jit
    def chain(t, v, p, c):
        el, fr = jkg.generate_sort_elements(t, v, p, c, config, capacity)
        el = jsort.sort_elements(el, config)
        return el, jranges.find_ranges(el, config.num_tiles), fr

    jel, jrg, jfr = chain(jax.tree.map(jnp.asarray, table), jnp.asarray(view),
                          jnp.asarray(proj), jnp.asarray(cam.position))
    return (jel, jrg, jfr), to_torch(jel, jrg, jfr)


def to_torch(el, rg, fr):
    i64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    te = tkg.SortElements(i64(el.tile), i64(el.depth), i64(el.index), i64(el.count))
    tf = tkg.GaussianFrameData(*(torch.from_numpy(np.array(a)) for a in fr))
    return te, i64(rg), tf


def _pack16(x, y):
    """Two float32 columns -> one float32-bitcast word holding (f16(x),
    f16(y)) (JAX blend_kernel._pack16)."""
    xb = x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    yb = y.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    w = xb | (yb << 16)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).view(torch.float32)


def _unpack16(w):
    """Inverse of `_pack16` on an [E] word column -> (x, y) float32."""
    bits = w.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def half(h):
        return torch.where(h >= 2**15, h - 2**16, h).to(torch.int16).view(torch.float16).float()

    return half(bits & 0xFFFF), half(bits >> 16)


def pack_feature_tables2(frame):
    """The JAX capped path's two [N, 4] tables (blend_kernel.py:85-158):
    (gx, gy, a', b') and (c', galpha, pack16(r, g), pack16(b, b))."""
    cov = frame.cov_inv * torch.tensor([-0.5, -1.0, -0.5])
    ca = frame.color_alpha
    table_a = torch.cat([frame.screen_pos, cov[:, 0:2]], dim=-1)
    table_b = torch.cat([cov[:, 2:3], ca[:, 3:4], _pack16(ca[:, 0], ca[:, 1])[:, None],
                         _pack16(ca[:, 2], ca[:, 2])[:, None]], dim=-1)
    return table_a, table_b


def rows_from_tables2(rows_a, rows_b):
    """[E, 4] x 2 -> the [E, 10] rows (gx, gy, a', b', c', 0, r, g, b,
    galpha), rgb rounded through float16 as JAX's capped gather carries it."""
    r, g = _unpack16(rows_b[:, 2])
    b, _ = _unpack16(rows_b[:, 3])
    return torch.cat([rows_a, rows_b[:, 0:1], torch.stack([torch.zeros_like(r), r, g, b], -1),
                      rows_b[:, 1:2]], dim=-1)


def assert_image_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for ch in range(3):
        d = np.abs(got[..., ch] - want[..., ch])
        assert d.max() <= FLOAT_TOL, f"{what} channel {ch}: float max |Δ| {d.max()}"
        q = np.abs(np.round(got[..., ch] * 255.0).astype(np.int32)
                   - np.round(want[..., ch] * 255.0).astype(np.int32))
        assert q.max() <= 1, f"{what} channel {ch}: 8-bit max |Δ| {q.max()}"


def assert_state_equal(got, want, what):
    if isinstance(want, jcap.CapsState):
        for f in ("caps", "thr", "floor"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)).astype(np.int64),
                                          err_msg=f"{what} {f}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64),
                                      err_msg=f"{what} caps")


def _thresholds(config, seed=8):
    """A mid-run threshold map: depth keys over the scene's range, a tenth
    of the tiles unfiltered (tests/test_prefilter.py)."""
    rng = np.random.default_rng(seed)
    thr = rng.integers(0, 200_000_000, config.num_tiles).astype(np.uint32)
    thr[rng.random(config.num_tiles) < 0.1] = 0xFFFFFFFF
    return thr


@pytest.mark.parametrize("kind", ["caps", "state"])
def test_capped_layout_matches_jax(kind):
    config = dataclasses.replace(DEEP, width=128, height=96)
    (jel, jrg, jfr), (te, tr, tf) = prepare(cloud_table(600), config)
    rng = np.random.default_rng(1)
    caps = rng.choice([32, 64, 200, 512], config.num_tiles).astype(np.int32)
    if kind == "caps":
        jcaps, tcaps = jnp.asarray(caps), torch.from_numpy(caps.astype(np.int64))
    else:
        jcaps = jcap.CapsState(caps=jnp.asarray(caps), thr=jnp.asarray(_thresholds(config)),
                               floor=jnp.asarray(caps))
        tcaps = convert.caps_state_from_jax(jcaps)
    want = _jit_layout(jel, jrg, jfr, config, jcaps)
    _ta, _tb, jgid, jlive, jpstart, jcounts, jr, jfits, jpend = (np.asarray(a) for a in want)
    launches = (LAUNCHES["expand_rows"], LAUNCHES["compact_slabs"])
    lay = tcap.capped_layout(te, tr, tf, convert.config_from_jax(config), tcaps)
    assert (LAUNCHES["expand_rows"], LAUNCHES["compact_slabs"]) == launches  # CPU: plain
    live = lay.gid.numpy() != 0xFFFFFFFF
    np.testing.assert_array_equal(live, jlive > 0)
    np.testing.assert_array_equal(lay.gid.numpy()[live], jgid[live].astype(np.int64))
    np.testing.assert_array_equal(lay.pstart.numpy(), jpstart)
    np.testing.assert_array_equal(lay.counts.numpy(), jcounts)
    np.testing.assert_array_equal(lay.r.numpy(), jr)
    assert bool(lay.fits) == bool(jfits) and int(lay.pcum_end) == int(jpend)
    assert live.sum() > 0
    if kind == "state":  # the crossing search trimmed some filtered tile
        assert (jcounts < np.minimum(jr, caps)).any()


@pytest.mark.parametrize("cap,with_t", [(0, False), (0, True), (8, True)])
def test_blend_flat_plain_matches_jax(cap, with_t):
    (jel, jrg, jfr), (te, tr, tf) = prepare(stacked_table(40, opacity=0.3), BASE)
    want = jax.jit(jbk.blend_tiles_pallas_flat, static_argnames=("config", "cap", "with_t"))(
        jel, jrg, jfr, BASE, cap=cap, with_t=with_t)
    launches = LAUNCHES["blend_flat"]
    got = tblend.blend_flat(tf, te.index, tr, convert.config_from_jax(BASE), cap=cap, with_t=with_t)
    assert LAUNCHES["blend_flat"] == launches
    if with_t:
        (got, t_got), (want, t_want) = got, want
        np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=T_RTOL, atol=T_ATOL)
        assert (t_got.numpy() < 1.0).any()
    assert_image_close(got, want, f"blend_flat cap={cap}")
    for ch in range(3):
        assert got[..., ch].mean() > 0


def _packed_blends(config, table, caps):
    """JAX's capped blend (capped_layout -> capped_gather's float16-rgb
    features -> blend_flat_core with T) and the port's layout, on one
    scene.  Returns (JAX (img, T), port inputs (layout, ranges, config,
    frame))."""
    (jel, jrg, jfr), (te, tr, tf) = prepare(table, config)
    ta, tb, jgid, jlive, jpstart, jcounts, *_ = _jit_layout(jel, jrg, jfr, config, jnp.asarray(caps))
    ep = jcap.packed_capacity_temporal(config, jel.tile.shape[0])
    feat = jcap.capped_gather(ta, tb, jgid, jlive, config.blend_batch_k)
    pr = jnp.stack([jpstart, jpstart + jcounts], axis=1).astype(jnp.uint32)
    want = _jit_flat(feat, pr, config, ep, with_t=True)
    tcfg = convert.config_from_jax(config)
    lay = tcap.capped_layout(te, tr, tf, tcfg, torch.from_numpy(caps.astype(np.int64)))
    pranges = torch.stack([lay.pstart, lay.pstart + lay.counts], dim=1)
    return want, (lay, pranges, tcfg, tf)


def test_blend_flat_batch_semantics_on_packed_layout():
    """K3 on the capped layout's own packed ranges, with JAX's float16 rgb
    rows: T carried to batch ends, tiles exiting only at batch boundaries."""
    config = dataclasses.replace(DEEP, blend_batch_k=128)
    caps = np.full(config.num_tiles, 256, np.int32)
    (want, t_want), (lay, pranges, tcfg, tf) = _packed_blends(
        config, stacked_table(300, opacity=0.95), caps)
    table16 = rows_from_tables2(*pack_feature_tables2(tf))
    got, t_got = tblend.blend_flat_plain(table16, lay.gid, pranges, tcfg, with_t=True)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=T_RTOL, atol=T_ATOL)
    assert_image_close(got, want, "packed blend_flat")
    # The T the policy reads lies far below the stop on saturated tiles.
    assert (t_got.amax(dim=1) < 1e-4 * 0.3).any()


def test_f16_rgb_delta():
    """B6: the port's capped blend gathers float32 rgb, JAX's float16.  On
    the same packed layout the two images stay inside the float contract,
    and with JAX's float16 rows the port's blend matches JAX's to 1e-5."""
    caps = np.full(TEMPORAL.num_tiles, 16, np.int32)
    (want, _t), (lay, pranges, tcfg, tf) = _packed_blends(
        TEMPORAL, stacked_table(40, opacity=0.3), caps)
    table16 = rows_from_tables2(*pack_feature_tables2(tf))
    got16 = tblend.blend_flat_plain(table16, lay.gid, pranges, tcfg)
    got32 = tblend.blend_flat_plain(tblend.pack_feature_table(tf), lay.gid, pranges, tcfg)
    d16 = np.abs(got16.numpy() - np.asarray(want)).max()
    d32 = np.abs(got32.numpy() - np.asarray(want)).max()
    assert_image_close(got32, want, "float32-rgb capped image")
    assert d16 <= 1e-5 < d32 <= FLOAT_TOL, (d16, d32)


@pytest.mark.parametrize("name,opacity,n,config", [
    ("translucent", 0.01, 40, TEMPORAL),
    ("saturated", 0.95, 300, DEEP),
])
def test_temporal_matches_jax_frame_by_frame(name, opacity, n, config):
    """8 frames of blend_tiles_capped_temporal (and the split path, with its
    stats): caps, ok and images equal frame by frame.  The translucent
    stack escalates its caps through patched and fallback frames; the
    saturated one validates by saturation."""
    (jel, jrg, jfr), (te, tr, tf) = prepare(stacked_table(n, opacity), config)
    tcfg = convert.config_from_jax(config)
    jcaps, tcaps = jcap.init_caps(config), tcap.init_caps(tcfg)
    full = np.asarray(jbk.blend_tiles_pallas_flat(jel, jrg, jfr, config))
    oks = []
    for i in range(8):
        want, jnext, jok, jstats = _jit_split(jel, jrg, jfr, config, jcaps)
        got, tnext, tok, tstats = tcap.blend_tiles_capped_split(te, tr, tf, tcfg, tcaps)
        assert bool(tok) == bool(jok), f"frame {i} ok"
        assert_state_equal(tnext, jnext, f"frame {i}")
        np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats), err_msg=f"frame {i}")
        assert_image_close(got, want, f"{name} frame {i}")
        assert_image_close(got, full, f"{name} frame {i} vs uncapped")
        got_m, mnext, mok = tcap.blend_tiles_capped_temporal(te, tr, tf, tcfg, tcaps)
        assert torch.equal(got_m, got) and torch.equal(mnext, tnext) and bool(mok) == bool(tok)
        jcaps, tcaps = jnext, tnext
        oks.append(bool(tok))
    assert oks[-1]
    assert int(tcaps.max()) > config.blend_depth_cap  # the caps moved


def test_narrow_tables_match_jax():
    """The float16 rows above are JAX's bit for bit (pack_feature_tables2,
    rows_from_tables2), so the f16 delta is measured against JAX's exact
    format."""
    (_jel, _jrg, jfr), (_te, _tr, tf) = prepare(cloud_table(300), BASE)
    ta, tb = jax.jit(jbk.pack_feature_tables2)(jfr)
    ta_t, tb_t = pack_feature_tables2(tf)
    np.testing.assert_array_equal(ta_t.numpy(), np.asarray(ta))
    np.testing.assert_array_equal(tb_t.numpy().view(np.uint32), np.asarray(tb).view(np.uint32))
    rows = jax.jit(jbk.rows_from_tables2)(ta, tb)
    np.testing.assert_array_equal(rows_from_tables2(ta_t, tb_t).numpy(), np.asarray(rows))
