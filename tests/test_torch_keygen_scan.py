"""K7's offset scan (csrc/keygen.cu, decoupled look-back) and K1 reading it.

On the CPU: the plain `Projection`'s offset row, inclusive scan `cum` and
`total` against a numpy scan of the jitted JAX package's counts, and the
port's sort elements against JAX's `generate_sort_elements` bit for bit,
on two scenes with the prefilter off and on and a capacity that clamps;
`expand_rows` / `expand_rows_streamed` over a scan against numpy's repeat
by the counts; a numpy model of the kernel's 64-bit look-back in random
interleavings; the guards.  On the card (`cuda` marker, skipped without
one): K7 against its plain version, every integer field bit for bit
(offset row, `cum`, `total` included), floats within 1 ulp as in
test_torch_keygen_kernel.py, and K1 over K7's scan.
"""

import dataclasses
import math

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

CONFIG = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
_jax_keygen = jax.jit(jkg.generate_sort_elements, static_argnames=("config", "capacity"))


@jax.jit
def _jax_counts(table, view, proj, depth_thr):
    """The JAX package's per-gaussian counts, generate_sort_elements' own
    expressions (keygen.py:183-189)."""
    _pv, visible, depth, _c2, screen_pos, extents = jkg._frame_geometry(table, view, proj, CONFIG)
    emit = jkg._emit_mask(visible, screen_pos, extents, depth, CONFIG, depth_thr)
    w = extents[:, 2] - extents[:, 0]
    h = extents[:, 3] - extents[:, 1]
    return jnp.where(emit, w * h, 0).astype(jnp.int32)


def _scene(k):
    """A 2,048-gaussian procedural cloud seen from camera k."""
    pos, rot = [((0.0, 0.0, 2.0), (math.pi, 0.0)), ((0.3, -0.2, 2.5), (3.0, -0.2))][k]
    cam = Camera(CONFIG.aspect)
    cam.set_position(pos)
    cam.set_rotation(*rot)
    table = jsyn.procedural_cloud_table(2048, seed=11 + k)
    return dataclasses.replace(table, scale=table.scale * np.float32(6.0)), cam


def _thresholds(keys, num_tiles, rng):
    """A [T] depth-threshold map in the nearest third of `keys`' range,
    one tile SENTINEL (filtering off there)."""
    lo, hi = int(keys.min()), int(keys.max()) + 1
    thr = rng.integers(lo, lo + (hi - lo) // 3 + 1, size=num_tiles, dtype=np.int64)
    thr[rng.integers(num_tiles)] = 0xFFFFFFFF
    return thr


@pytest.mark.parametrize("scene", [0, 1])
def test_plain_scan_and_elements_match_jax(scene):
    """The plain Projection's offset row, cum and total equal a numpy scan
    of the jitted JAX package's counts, and the port's SortElements equal
    JAX's generate_sort_elements bit for bit, with the prefilter off and
    on, at the default capacity and at one that cuts the list."""
    jtable, cam = _scene(scene)
    view, proj = cam.matrices()
    jt = JaxTable(**{f: jnp.asarray(np.asarray(getattr(jtable, f))) for f in
                     ("position", "scale", "rot", "sh", "opacity")})
    tt = convert.table_from_jax(jtable)
    tcfg = convert.config_from_jax(CONFIG)
    keys = kk.project_gaussians_plain(tt, view, proj, cam.position, tcfg, 1).cols[5]
    thr = _thresholds(keys.to(torch.int64) & 0xFFFFFFFF, CONFIG.num_tiles,
                      np.random.default_rng(scene))
    live = []
    for t in (None, thr):
        jthr = None if t is None else jnp.asarray(t.astype(np.uint32))
        counts = np.asarray(_jax_counts(jt, jnp.asarray(view), jnp.asarray(proj), jthr),
                            np.int64)
        cum = np.cumsum(counts)
        total = int(cum[-1])
        tthr = None if t is None else torch.from_numpy(t)
        dil = None if t is None else prefilter.dilate_thresholds(tthr, tcfg)
        for capacity in (CONFIG.sort_capacity(2048), total // 2):
            p = kk.project_gaussians(tt, view, proj, cam.position, tcfg, capacity, dil)
            np.testing.assert_array_equal(p.cum.numpy(), cum)
            assert p.total.dtype == torch.int64 and int(p.total) == total
            np.testing.assert_array_equal(p.cols[1].numpy(),
                                          np.minimum(cum - counts, capacity).astype(np.int32))
            je, _jf = _jax_keygen(jt, jnp.asarray(view), jnp.asarray(proj),
                                  jnp.asarray(cam.position), config=CONFIG, capacity=capacity,
                                  depth_thr=jthr)
            te, _tf = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, capacity,
                                                 tthr)
            for name in ("tile", "depth", "index"):
                np.testing.assert_array_equal(getattr(te, name).numpy(),
                                              np.asarray(getattr(je, name)).astype(np.int64))
            assert int(te.count) == int(je.count) == min(total, capacity)
        counted = kk.project_gaussians(tt, view, proj, cam.position, tcfg, None, dil)
        assert counted.cum is None and int(counted.total) == total
        assert int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg, tthr)) == total
        live.append(total)
    assert live[0] > live[1] > 0  # the thresholds filtered some elements
    assert LAUNCHES["keygen_project"] == LAUNCHES["keygen_count"] == 0


def test_expand_given_cum_equals_counts_only():
    """expand_rows and expand_rows_streamed given the inclusive scan equal
    numpy's repeat of the rows by the counts alone: a total above the
    capacity, one below, and N = 0.  The wrappers read the scan: the
    exclusive one in its place expands other rows, and a scan that falls
    is refused."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 9, size=700)
    counts[rng.random(700) < 0.4] = 0
    cols_np = rng.integers(-2**31, 2**31, size=(6, 700), dtype=np.int64).astype(np.int32)
    cols = torch.from_numpy(cols_np)
    cum = torch.cumsum(torch.from_numpy(counts), 0)
    total = int(counts.sum())
    cases = [(700, total // 2), (700, total + 37), (0, 64)]
    for fn in (expand_kernel.expand_rows, expand_kernel.expand_rows_streamed):
        for n, capacity in cases:
            want = np.zeros((6, capacity), np.int32)
            rep = np.repeat(cols_np[:, :n], counts[:n], axis=1)[:, :capacity]
            want[:, : rep.shape[1]] = rep
            got, got_total = fn(cols[:, :n], cum[:n], capacity)
            np.testing.assert_array_equal(got.numpy(), want)
            assert got_total.dtype == torch.int64 and int(got_total) == int(counts[:n].sum())
        shifted, _ = fn(cols, cum - torch.from_numpy(counts), total)
        assert not torch.equal(shifted, fn(cols, cum, total)[0])
        with pytest.raises(ValueError, match="scan"):
            fn(cols, cum.flip(0), total)
    assert LAUNCHES["expand_rows"] == LAUNCHES["expand_rows_streamed"] == 0


# csrc/keygen.cu's status words (the flag above 62 sum bits) and its
# look-back window (warp 0's lanes); the model's blocks are K7's 64
# gaussians, though the protocol does not depend on their width.
SUM_BITS = 62
AGGREGATE = 1 << SUM_BITS
INCLUSIVE = 2 << SUM_BITS
SUM_MASK = AGGREGATE - 1
WINDOW = 32
THREADS = 64


def _window(status, part, end):
    """One step of csrc/keygen.cu's look-back for partition `part` over the
    window of predecessors end, end - 1, ..., end - 31: None while a lane's
    word is unpublished (the lane spins), else (the sum of the words up to
    the nearest INCLUSIVE one, whether one was found)."""
    words = []
    for lane in range(WINDOW):
        k = end - lane
        w = INCLUSIVE if k < 0 else int(status[k])
        if w < AGGREGATE:
            return None
        words.append(w)
    found = [w >= INCLUSIVE for w in words]
    stop = found.index(True) if any(found) else WINDOW - 1
    return sum(w & SUM_MASK for w in words[: stop + 1]), any(found)


def test_lookback_model_in_any_order():
    """The kernel's protocol in a numpy model: blocks take tickets in order,
    publish their AGGREGATE (partition 0 INCLUSIVE), and walk back 32 words a
    step in a random interleaving, waiting where a word is unpublished;
    zero-count blocks publish a flagged 0, sums pass 2^32.  Each block's
    prefix, its offsets clamped to the capacity (as int32), the inclusive
    scan and the total equal numpy's, and every word ends INCLUSIVE."""
    rng = np.random.default_rng(13)
    parts = 300
    counts = rng.integers(0, 1 << 26, size=(parts, THREADS), dtype=np.int64)
    counts[rng.random((parts, THREADS)) < 0.3] = 0
    counts[rng.choice(parts, 40, replace=False)] = 0  # whole blocks without elements
    flat = counts.reshape(-1)
    want_cum = np.cumsum(flat)
    total = int(want_cum[-1])
    assert total > 1 << 32 and total < 1 << SUM_BITS
    capacity = total // 3
    status = np.zeros(parts, np.uint64)
    started = 0
    walking = {}  # part -> [window end, prefix so far]
    prefix = np.full(parts, -1, np.int64)
    while (prefix < 0).any():
        if started < parts and (not walking or rng.random() < 0.4):
            p = started  # the next ticket: computes its counts, publishes
            started += 1
            agg = int(counts[p].sum())
            status[p] = np.uint64((INCLUSIVE if p == 0 else AGGREGATE) | agg)
            if p == 0:
                prefix[0] = 0
            else:
                walking[p] = [p - 1, 0]
            continue
        p = list(walking)[int(rng.integers(len(walking)))]
        end, acc = walking[p]
        step = _window(status, p, end)
        if step is None:
            continue  # a lane waits on an earlier block's word
        add, found = step
        if not found:
            walking[p] = [end - WINDOW, acc + add]
            continue
        del walking[p]
        prefix[p] = acc + add
        status[p] = np.uint64(INCLUSIVE | (acc + add + int(counts[p].sum())))
    block_excl = np.cumsum(counts.sum(1)) - counts.sum(1)
    assert np.array_equal(prefix, block_excl)
    off = np.repeat(prefix, THREADS) + (np.cumsum(counts, 1) - counts).reshape(-1)
    cum = off + flat
    offsets = np.minimum(off, capacity).astype(np.int32)
    assert np.array_equal(cum, want_cum) and int(cum[-1]) == total
    assert np.array_equal(offsets, np.minimum(want_cum - flat, capacity).astype(np.int32))
    assert (status >> np.uint64(SUM_BITS) == 2).all()
    assert np.array_equal((status & np.uint64(SUM_MASK)).astype(np.int64),
                          np.cumsum(counts.sum(1)))


def test_scan_guards():
    """A cum of the wrong dtype, shape or device raises in both expansion
    wrappers; the launchers refuse CPU tensors; K7's outputs (views of three
    allocations) have their shapes and dtypes, 16-byte aligned float rows,
    and the scratch past the total and the scan."""
    for n in (0, 1, 63, 64, 65, 1001):
        words = 1 + -(-n // THREADS)
        out, scratch = kk._outputs(n, torch.device("cpu"), words, True)
        want = kk.project_gaussians_plain(
            convert.table_from_jax(jsyn.procedural_cloud_table(n, seed=1)),
            *_scene(0)[1].matrices(), _scene(0)[1].position, convert.config_from_jax(CONFIG),
            64, with_aux=True)
        for name in kk.INT_FIELDS + kk.FLOAT_FIELDS:
            got, ref = getattr(out, name), getattr(want, name)
            assert got.shape == ref.shape and got.dtype == ref.dtype, name
            assert got.is_contiguous() and (got.data_ptr() % 16 == 0 or got.dtype != torch.float32)
        assert scratch.numel() == words
        total = out.total.data_ptr()  # then cum, then the scratch
        assert scratch.data_ptr() == total + 8 * (n + 1)
        assert n == 0 or out.cum.data_ptr() == total + 8
        counted, none = kk._outputs(n, torch.device("cpu"), None, False)
        assert none is None and counted.total.shape == () and counted.cum is None
    cols = torch.zeros((6, 5), dtype=torch.int32)
    cum = torch.arange(1, 6, dtype=torch.int64)
    for fn in (expand_kernel.expand_rows, expand_kernel.expand_rows_streamed):
        with pytest.raises(ValueError, match="int64"):
            fn(cols, cum.to(torch.int32), 8)
        with pytest.raises(ValueError, match="int64"):
            fn(cols, cum[:4], 8)
        with pytest.raises(ValueError, match="int64"):
            fn(cols, cum[None], 8)
        with pytest.raises(ValueError, match="one device"):
            fn(cols, torch.empty(5, dtype=torch.int64, device="meta"), 8)
    with pytest.raises(ValueError, match="device"):
        expand_kernel._launch("expand_rows", cols, cum, 8)
    jtable, cam = _scene(0)
    view, proj = cam.matrices()
    with pytest.raises(ValueError, match="device"):
        kk._launch_project(convert.table_from_jax(jtable), view, proj, cam.position,
                           convert.config_from_jax(CONFIG), 64)
    assert LAUNCHES["expand_rows"] == LAUNCHES["expand_rows_streamed"] == LAUNCHES["keygen_project"] == 0


def _card_table(n, rng, cover=False):
    """n gaussians in front of the camera at (0, 0, 2) looking down -z,
    scale ~0.02 (a few tiles each), or, with `cover`, large enough that
    each covers the whole grid."""
    pos = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.35, 0.35, n),
                    rng.uniform(-1.0, 1.0, n)], 1).astype(np.float32)
    scale = np.full((n, 3), 20.0 if cover else 0.02, np.float32)
    scale *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True) + np.float32(1e-12)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    opacity = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return convert.table_from_jax(JaxTable(pos, scale, rot, sh, opacity), device="cuda")


def _assert_matches_plain(args, what):
    got = kk.project_gaussians(*args, with_aux=True)
    want = kk.project_gaussians_plain(*args, with_aux=True)
    for name, v in kk.projection_mismatch(got, want).items():
        if name in kk.INT_FIELDS:
            assert v == 0, f"{what}: {name} differs at {v} values"
        else:
            assert v[1] <= 1, f"{what}: {name} {v[0]} values, max ulp {v[1]}"
    return got


@pytest.mark.cuda
def test_scan_matches_plain_on_cuda():
    """K7 against its plain version on the card, every integer field bit for
    bit (offset row, cum and total included): N in {0, 1, 255, 256, 257,
    2^20 + 3}, prefilter off and on, the counts mode, the three SH modes;
    calls back to back at different N and capacity (the scratch comes back
    with the last call's flags), five repeats equal; a scan past 2^31 and
    2^32 at 1080p."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K7 is a CUDA kernel with no CPU mode")
    rng = np.random.default_rng(21)
    cam = Camera(1280 / 720)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    view, proj = cam.matrices()
    config = convert.config_from_jax(RenderConfig(width=1280, height=720))
    for n in (0, 1, 255, 256, 257, (1 << 20) + 3):
        t = _card_table(n, rng)
        capacity = config.sort_capacity(max(n, 1))
        full = kk.project_gaussians_plain(t, view, proj, cam.position, config, capacity)
        keys = full.cols[5].to(torch.int64) & 0xFFFFFFFF
        thr = None if n == 0 else prefilter.dilate_thresholds(
            torch.from_numpy(_thresholds(keys.cpu(), config.num_tiles, rng)).cuda(), config)
        for mode in SphericalHarmonicsMode:
            cfg = dataclasses.replace(config, sh_mode=mode)
            for dil in (None, thr):
                for cap in (None, capacity, max(int(full.total) // 2, 1)):
                    _assert_matches_plain((t, view, proj, cam.position, cfg, cap, dil),
                                          f"n={n} {mode.name} thr={dil is not None} cap={cap}")
    big, small = _card_table((1 << 20) + 3, rng), _card_table(257, rng)
    calls = [(big, 14_190_624), (small, 100), (big, 1 << 20), (small, 1 << 20)]
    outs = [kk.project_gaussians(tb, view, proj, cam.position, config, c) for tb, c in calls]
    outs += [kk.project_gaussians(big, view, proj, cam.position, config, 1 << 20)
             for _ in range(5)]
    torch.cuda.synchronize()
    for (tb, c), got in zip(calls + [calls[2]] * 5, outs):
        want = kk.project_gaussians_plain(tb, view, proj, cam.position, config, c)
        for name in ("cols", "cum", "total"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, tb.num_gaussians)
    hd = convert.config_from_jax(RenderConfig(width=1920, height=1080))
    cam.set_aspect(1920 / 1080)
    view, proj = cam.matrices()
    cover = _card_table((1 << 20) + 3, rng, cover=True)
    got = _assert_matches_plain((cover, view, proj, cam.position, hd, 14_190_624, None),
                                "whole-grid gaussians at 1080p")
    assert int(got.total) > 1 << 32 and int((got.cum > 1 << 31).sum()) > 0
    assert int(torch.diff(got.cum).max()) == hd.num_tiles
    p = outs[2]  # K1 over K7's scan, a total past the capacity
    got_k1, total = expand_kernel.expand_rows(p.cols, p.cum, 1 << 20)
    want_k1, want_total = expand_kernel.expand_rows_plain(p.cols, p.cum, 1 << 20)
    assert torch.equal(got_k1, want_k1) and int(total) == int(want_total) == int(p.total)
    torch.cuda.synchronize()
