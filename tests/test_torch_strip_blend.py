"""Port parity: K4, the distributed frame's carry-aware strip blend.

`blend_strip_plain` (ops/blend.py), reached through
ops/cuda/blend_kernel.py:blend_strip on CPU tensors, against the JAX Pallas
`blend_strip_colors_pallas` (interpret mode) on the same sorted elements,
ranges, frame data and carries: random carries, saturated carries and
`tile_base > 0`, with the per-gaussian table and with routed rows.  JAX's
kernel runs T as a per-batch cumulative-product tree, the port's plain
version sequentially, so the bounds are: colours |Δ| <= 1e-4 per channel,
exp(logT) at rtol 1e-4 with atol = float32's smallest normal (XLA on the
CPU flushes subnormal T to zero, torch keeps it).  On a card, the CUDA
kernel stops each pixel at T < transmittance_stop where the plain version
keeps multiplying T to its batch's end, so it is held to its plain version
by `assert_strip_matches_plain`: colours bit for bit, log T bit for bit
wherever the plain T >= the stop, both T below the stop elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.models.gaussians import NUM_SH_COEFFS, GaussianTable
from vk3dgaussiansplatting_tpu.ops import blend as jblend
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.ops.pallas import blend_kernel as jbk
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda import blend_kernel as tbk

torch.set_num_threads(1)

# 4x4 tiles, strips of 2 tile rows; 128-element batches so that a tile's
# range spans several of them.
CONFIG = RenderConfig(width=64, height=64, capacity_slack_per_tile=512,
                      sort_algorithm=SortAlgorithm.XLA_SORT, blend_batch_k=128)
STRIP_TILES = 8
STRIP_CONFIG = dataclasses.replace(CONFIG, height=32)
COLOR_ATOL = 1e-4
T_RTOL = 1e-4
T_ATOL = float(np.finfo(np.float32).tiny)


def _table(n=300, seed=9):
    """n large gaussians stacked in depth: the four centre tiles saturate
    after a batch or two, the outer tiles' corners stay unsaturated."""
    rng = np.random.default_rng(seed)
    position = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                         np.linspace(-1.0, -3.0, n)], axis=1).astype(np.float32)
    sh = np.zeros((n, NUM_SH_COEFFS, 3), np.float32)
    sh[:, 0, :] = rng.uniform(0.2, 1.0, (n, 3))
    return GaussianTable(position=position,
                         scale=rng.uniform(0.5, 3.0, (n, 3)).astype(np.float32),
                         rot=np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)), sh=sh,
                         opacity=rng.uniform(0.05, 0.3, n).astype(np.float32))


@pytest.fixture(scope="module")
def frame():
    """JAX keygen -> sort -> ranges, and the same as port tensors."""
    table = _table()
    cam = Camera(CONFIG.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(np.pi, 0.0)
    view, proj = cam.matrices()
    capacity = CONFIG.sort_capacity(table.num_gaussians)

    @jax.jit
    def chain(t, v, p, c):
        el, fr = jkg.generate_sort_elements(t, v, p, c, CONFIG, capacity)
        el = jsort.sort_elements(el, CONFIG)
        return el, jranges.find_ranges(el, CONFIG.num_tiles), fr

    jel, jrg, jfr = chain(jax.tree.map(jnp.asarray, table), jnp.asarray(view),
                          jnp.asarray(proj), jnp.asarray(cam.position))
    i64 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    te = tkg.SortElements(i64(jel.tile), i64(jel.depth), i64(jel.index), i64(jel.count))
    tf = tkg.GaussianFrameData(*(torch.from_numpy(np.array(a)) for a in jfr))
    assert int(te.count) < capacity
    return (jel, jrg, jfr), (te, i64(jrg), tf)


def _carries(kind, seed=5):
    rng = np.random.default_rng(seed)
    p = CONFIG.tile_size**2
    cc = rng.uniform(0.0, 0.6, (STRIP_TILES, p, 3)).astype(np.float32)
    cl = np.log(rng.uniform(1e-3, 1.0, (STRIP_TILES, p))).astype(np.float32)
    if kind == "saturated":
        cl[:3] = np.log(np.float32(1e-5))  # every pixel below the stop: passes through
        cl[3] = -np.inf  # T = 0
        cl[4, ::2] = np.log(np.float32(1e-6))  # half the pixels: the tile still runs
    return cc, cl


def _rows(te, tf):
    """pack_feature_table's rows in slot order, as the exchange routes them."""
    return tbk.pack_feature_table(tf)[torch.where(te.index == SENTINEL, 0, te.index)]


def assert_strip_matches_plain(got, want, t_stop):
    """K4's criterion against blend_strip_plain (`blend_kernel.strip_mismatch`):
    colours bit for bit, log T where the plain T >= t_stop, both T below
    t_stop elsewhere (all that the next phase's carry reads)."""
    fault = tbk.strip_mismatch(got, want, t_stop)
    assert fault is None, fault


def strip_cases(te, tf):
    """(rows, gather, tile_base, carry colour, carry log T) over routed and
    gathered rows, both strips, random and saturated carries."""
    for gather in (False, True):
        rows = tbk.pack_feature_table(tf) if gather else _rows(te, tf)
        for tile_base in (0, STRIP_TILES):
            for kind in ("random", "saturated"):
                cc, cl = (torch.from_numpy(x) for x in _carries(kind, seed=5 + tile_base))
                yield rows, gather, tile_base, cc, cl


def _assert_strip_close(got, want_colors, want_logt):
    colors, logt = (x.numpy() for x in got)
    want_colors, want_logt = np.asarray(want_colors), np.asarray(want_logt)
    assert colors.shape == want_colors.shape and logt.shape == want_logt.shape
    for ch in range(3):
        d = np.abs(colors[..., ch] - want_colors[..., ch])
        assert d.max() <= COLOR_ATOL, f"channel {ch}: max |Δ| {d.max()}"
    np.testing.assert_allclose(np.exp(logt), np.exp(want_logt), rtol=T_RTOL, atol=T_ATOL)


@pytest.mark.parametrize("case,tile_base", [("random", 0), ("saturated", 8), ("routed", 8)])
def test_strip_plain_matches_pallas(frame, case, tile_base):
    (jel, jrg, jfr), (te, tr, tf) = frame
    cc, cl = _carries(case)
    if case == "routed":  # per-element features in sorted order, no table
        feats = jblend.gather_element_features(jel, jfr)
        want = jbk.blend_strip_colors_pallas(jel, jrg, None, STRIP_CONFIG, jnp.int32(tile_base),
                                             jnp.asarray(cc), jnp.asarray(cl), features=feats)
        rows, gather = _rows(te, tf), False
    else:
        want = jbk.blend_strip_colors_pallas(jel, jrg, jfr, STRIP_CONFIG, jnp.int32(tile_base),
                                             jnp.asarray(cc), jnp.asarray(cl))
        rows, gather = tbk.pack_feature_table(tf), True
    launches = tbk.STRIP_LAUNCHES
    got = tbk.blend_strip(rows, te.index, tr[tile_base:tile_base + STRIP_TILES],
                          convert.config_from_jax(CONFIG), tile_base=tile_base,
                          carry_color=torch.from_numpy(cc), carry_logt=torch.from_numpy(cl),
                          gather=gather)
    assert tbk.STRIP_LAUNCHES == launches  # CPU tensors: the plain version
    _assert_strip_close(got, *want)
    colors, logt = got
    assert (colors.numpy() != cc).any()  # the strip's elements were blended
    if case == "saturated":
        np.testing.assert_array_equal(colors[:4].numpy(), cc[:4])  # passed through
        assert (logt[3] == -np.inf).all()
        assert (colors[4].numpy() != cc[4]).any()


def test_strip_routed_rows_equal_table_gather(frame):
    """Routed rows (dead slots' rows NaN) and the per-gaussian table gathered by
    id give the same strip, bit for bit."""
    _, (te, tr, tf) = frame
    cc, cl = (torch.from_numpy(x) for x in _carries("random"))
    cfg = convert.config_from_jax(CONFIG)
    kw = dict(tile_base=8, carry_color=cc, carry_logt=cl)
    rows = _rows(te, tf)
    rows[te.index == SENTINEL] = float("nan")
    routed = tbk.blend_strip(rows, te.index, tr[8:16], cfg, **kw)
    gathered = tbk.blend_strip(tbk.pack_feature_table(tf), te.index, tr[8:16], cfg, gather=True, **kw)
    for a, b in zip(routed, gathered):
        assert torch.equal(a, b)
    assert torch.isfinite(routed[0]).all()


def test_zero_carry_strip_equals_flat_blend(frame):
    """With carry (colour 0, log T 0) over every tile, K4's plain version is
    K3's: the same clipped image and log of K3's T, bit for bit."""
    _, (te, tr, tf) = frame
    cfg = convert.config_from_jax(CONFIG)
    table = tbk.pack_feature_table(tf)
    p = cfg.tile_size**2
    colors, logt = tblend.blend_strip_plain(
        table, te.index, tr, cfg, tile_base=0, carry_color=torch.zeros(cfg.num_tiles, p, 3),
        carry_logt=torch.zeros(cfg.num_tiles, p), gather=True)
    img, t = tblend.blend_flat_plain(table, te.index, tr, cfg, with_t=True)
    assert torch.equal(tblend.assemble_tile_colors(colors, cfg), img)
    assert torch.equal(logt, torch.log(t))
    assert (t.amax(dim=1) < cfg.transmittance_stop).any() and (t > cfg.transmittance_stop).any()


def test_depth_bands_chain_like_one_pass(frame):
    """Each tile's range split into a front and a back band, blended in two
    calls with the carry between them, gives the one-call strip: colours to
    float rounding (the carry's exp(log T) round trip), and T wherever it
    stayed above the stop (every element multiplied it in both)."""
    _, (te, tr, tf) = frame
    cfg = convert.config_from_jax(CONFIG)
    rows = _rows(te, tf)
    start, end = tr[8:16, 0], tr[8:16, 1]
    mid = start + (end - start) // 2
    cc, cl = (torch.from_numpy(x) for x in _carries("random"))
    one = tbk.blend_strip(rows, te.index, tr[8:16], cfg, tile_base=8, carry_color=cc, carry_logt=cl)
    front = tbk.blend_strip(rows, te.index, torch.stack([start, mid], 1), cfg, tile_base=8,
                            carry_color=cc, carry_logt=cl)
    back = tbk.blend_strip(rows, te.index, torch.stack([mid, end], 1), cfg, tile_base=8,
                           carry_color=front[0], carry_logt=front[1])
    np.testing.assert_allclose(back[0].numpy(), one[0].numpy(), rtol=0, atol=1e-5)
    alive = one[1].exp() >= cfg.transmittance_stop
    assert alive.any() and (~alive).any()
    np.testing.assert_allclose(back[1].exp()[alive].numpy(), one[1].exp()[alive].numpy(), rtol=1e-5)


def test_blend_strip_guards(frame):
    _, (te, tr, tf) = frame
    cfg = convert.config_from_jax(CONFIG)
    rows = _rows(te, tf)
    p = cfg.tile_size**2
    cc, cl = torch.zeros(STRIP_TILES, p, 3), torch.zeros(STRIP_TILES, p)
    with pytest.raises(ValueError, match="carries"):
        tbk.blend_strip(rows, te.index, tr[:8], cfg, tile_base=0, carry_color=cc[:4], carry_logt=cl)
    with pytest.raises(ValueError, match="outside"):
        tbk.blend_strip(rows, te.index, tr[:8], cfg, tile_base=12, carry_color=cc, carry_logt=cl)
    with pytest.raises(ValueError, match="rows for"):
        tbk.blend_strip(rows[:-1], te.index, tr[:8], cfg, tile_base=0, carry_color=cc,
                        carry_logt=cl)
    with pytest.raises(ValueError, match="int64"):
        tbk.blend_strip(rows, te.index.int(), tr[:8], cfg, tile_base=0, carry_color=cc,
                        carry_logt=cl)


@pytest.mark.cuda
def test_strip_kernel_matches_plain_on_cuda(frame):
    """K4 on the card against its plain version to its criterion
    (`assert_strip_matches_plain`): routed rows and table gather, both
    strips, random and saturated carries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 is a CUDA kernel with no CPU mode")
    _, (te, tr, tf) = frame
    cfg = convert.config_from_jax(CONFIG)
    index = te.index.cuda()
    for rows, gather, tile_base, cc, cl in strip_cases(te, tf):
        kw = dict(tile_base=tile_base, carry_color=cc.cuda(), carry_logt=cl.cuda(), gather=gather)
        ranges = tr[tile_base : tile_base + STRIP_TILES].cuda()
        launches = tbk.STRIP_LAUNCHES
        got = tbk.blend_strip(rows.cuda(), index, ranges, cfg, **kw)
        assert tbk.STRIP_LAUNCHES == launches + 1
        want = tblend.blend_strip_plain(rows.cuda(), index, ranges, cfg, **kw)
        assert_strip_matches_plain(got, want, cfg.transmittance_stop)
