"""The frame's radix path in two sorts (ops/sort.py `depth_first`): keygen's
rows put in the stable order of their depth keys before the expansion
(`radix_kernel.depth_order`, between K7 and K1), then a stable sort of the
elements on the tile alone (the "tile" key).

On the CPU (the plain versions): the sorted list and its ranges against
the JAX package's `sort_elements_xla(generate_sort_elements(...))` bit for
bit, on a 720p and a 1080p grid, a power-of-two tile count, gaussians with
equal depth keys sharing tiles, many rows with no slot, a total above the
capacity (a gaussian straddling it) and the prefilter's thresholds; the
depth-ordered expansion against JAX's index-order list stably reordered by
depth; the row order against a numpy model on crafted rows; the keys'
schedules; which frame paths take the depth order; which sort a depth
column (the uncapped radix frame's does not, and its image is the
three-column frame's).  At grids whose rows' word holds h in fewer bits
than the grid's height needs (256 x 128, the native 5187 x 3361 frame's
325 x 211, 1024 x 32 tiles): the row order against the numpy model, the
sorted list and ranges against JAX's and the index-order path's, and a
4096 x 2048 frame's image against the index-order frame's and
splatbench's reference.  On the card (`cuda` marker, skipped without one):
the row order and the tile-key sort bit for bit with their plain versions
at garden's and train7k's sizes, a native frame's row order, list, ranges
and image, the two-column sort against its plain
version and the three-column sort, the launches a frame on each path, and
no spill or stack in ptxas's report of the radix kernels.
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prefilter import CONFIG as PREFILTER_CONFIG
from test_torch_prefilter import thresholds, walled_scene
from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.render.camera import Camera
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import Renderer, convert, pipeline
from vk3dgaussiansplatting_tpu_torch import RenderConfig as TorchConfig
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.core.config import SortAlgorithm as TorchSort
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import ranges as tranges
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build
from vk3dgaussiansplatting_tpu_torch.ops.cuda import radix_kernel as rk
from vk3dgaussiansplatting_tpu_torch.parallel import dist as td
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera as TorchCamera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic

torch.set_num_threads(1)

_jax_keygen = jax.jit(jkg.generate_sort_elements, static_argnames=("config", "capacity"))
_jax_sort = jax.jit(jsort.sort_elements_xla, static_argnames=("num_tiles",))
_jax_ranges = jax.jit(jranges.find_ranges, static_argnames=("num_tiles",))

CLOUD_POSE = ((0.0, 0.0, 2.0), (math.pi, 0.0))
# A pose at the cloud's edge, looking across it.
EDGE_POSE = ((1.0, 0.5, -3.0), (0.2, 0.1))
CASES = ["720p", "1080p", "pow2_tiles", "equal_depths", "zero_counts", "over_capacity",
         "prefilter"]
# Frames whose tile grids (256 x 128, 325 x 211 at the native 5187 x 3361
# capture size, 1024 x 32) pass the 32 bits of a record word that holds
# every h: the word's h field is narrower there (`radix_kernel.rows_wide`).
WIDE = {"256x128": (4096, 2048), "325x211": (5187, 3361), "1024x32": (16384, 512)}


def _cloud(n=2048, mult=3.0, copies=0):
    """The keygen tests' procedural cloud, its scales times `mult`; with
    `copies`, its first 200 gaussians repeated `copies` times at the end
    (equal positions and extents: equal depth keys in shared tiles)."""
    table = jsyn.procedural_cloud_table(n, seed=11)
    table = dataclasses.replace(table, scale=table.scale * np.float32(mult))
    if copies:
        table = jax.tree.map(lambda a: np.concatenate([a] + [a[:200]] * copies), table)
        rng = np.random.default_rng(5)  # the copies differ in colour and opacity only
        table = dataclasses.replace(
            table, opacity=rng.uniform(0.2, 0.9, table.opacity.shape).astype(np.float32))
    return table


def _case(name):
    """(JAX table, camera, JAX config, depth_thr or None, capacity rule)."""
    config = RenderConfig(width=1280, height=720, sort_algorithm=SortAlgorithm.XLA_SORT,
                          expansion_method="repeat")
    pose, thr, table, capacity = CLOUD_POSE, None, None, "fits"
    if name == "1080p":
        config = dataclasses.replace(config, width=1920, height=1080)
    elif name == "pow2_tiles":  # 32 x 32 tiles: tile' needs an 11th bit
        config = dataclasses.replace(config, width=512, height=512)
    elif name == "equal_depths":
        table = _cloud(copies=3)
    elif name == "zero_counts":
        pose = EDGE_POSE
    elif name == "over_capacity":
        capacity = "half"
    elif name in WIDE:
        config = dataclasses.replace(config, width=WIDE[name][0], height=WIDE[name][1])
    elif name == "prefilter":  # 16 x 16 tiles
        config = dataclasses.replace(PREFILTER_CONFIG, expansion_method="repeat")
        table, thr = walled_scene(), thresholds(PREFILTER_CONFIG, seed=1)
        pose = ((0.3, -0.2, 2.5), (3.0, -0.2))
    cam = Camera(config.aspect)
    cam.set_position(pose[0])
    cam.set_rotation(*pose[1])
    return (_cloud() if table is None else table), cam, config, thr, capacity


def _lists(name):
    """JAX's index-order list and its sort, and the port's depth-ordered
    list and its tile-key sort, on one case; plus the live total."""
    table, cam, config, thr, rule = _case(name)
    view, proj = cam.matrices()
    tt, tcfg = convert.table_from_jax(table), convert.config_from_jax(config)
    tthr = None if thr is None else torch.from_numpy(thr.astype(np.int64))
    total = int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg, depth_thr=tthr))
    capacity = total // 2 + 3 if rule == "half" else total + 1001
    assert tsort.depth_first(tcfg)
    jargs = (jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
             jnp.asarray(cam.position))
    je, _ = _jax_keygen(*jargs, config, capacity,
                        depth_thr=None if thr is None else jnp.asarray(thr))
    te, _ = tkg.generate_sort_elements(tt, view, proj, cam.position,
                                       dataclasses.replace(tcfg, expansion_method="auto"),
                                       capacity, tthr, depth_order=True)
    return je, te, config, total, capacity


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("name", CASES)
def test_depth_first_sort_matches_jax(name):
    """The tile-key sort of the depth-ordered list, and its ranges, equal
    JAX's sorted list and ranges bit for bit."""
    je, te, config, total, capacity = _lists(name)
    num_tiles = config.num_tiles
    js = _jax_sort(je, num_tiles=num_tiles)
    ts = tsort.sort_elements(te, convert.config_from_jax(config), depth_ordered=True)
    for col in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(ts, col).numpy(), _np(getattr(js, col)), col)
    assert int(ts.count) == int(js.count) == min(total, capacity) > 0
    np.testing.assert_array_equal(tranges.find_ranges(ts, num_tiles).numpy(),
                                  _np(_jax_ranges(js, num_tiles=num_tiles)))
    if name == "over_capacity":
        assert total > capacity
    if name == "equal_depths":  # ties in (tile, depth) are frequent and resolved by id
        t, d = ts.tile[: int(ts.count)], ts.depth[: int(ts.count)]
        assert int(((t[1:] == t[:-1]) & (d[1:] == d[:-1])).sum()) > 100


@pytest.mark.parametrize("name", ["720p", "equal_depths", "zero_counts", "over_capacity",
                                  "prefilter"])
def test_depth_ordered_expansion_is_index_order_by_depth(name):
    """The depth-ordered expansion holds JAX's index-order list stably
    reordered by depth: the same elements, in (depth, id, row-major tile)
    order, with the same SENTINEL tail and count."""
    je, te, _config, _total, _capacity = _lists(name)
    n = int(je.count)
    assert int(te.count) == n
    order = np.argsort(_np(je.depth)[:n], kind="stable")
    for col in ("tile", "depth", "index"):
        want = _np(getattr(je, col))
        want[:n] = want[:n][order]
        np.testing.assert_array_equal(getattr(te, col).numpy(), want, col)


def _rows(rng, n, counts, capacity, depth):
    """K7-like rows: counts w * h with max(w, 1), min_x, min_y inside a
    120 x 68 grid, the depth bits as int32, and their inclusive scan."""
    w = rng.integers(1, 9, n)
    h = np.where(counts > 0, counts // np.maximum(w, 1), 0)
    return _rows_of(rng, w, h, rng.integers(0, 121, n), rng.integers(0, 69, n), capacity, depth)


def _rows_of(rng, w, h, min_x, min_y, capacity, depth):
    counts = w * h
    cum = np.cumsum(counts)
    cols = np.stack([np.arange(w.shape[0]), np.minimum(cum - counts, capacity), w, min_x, min_y,
                     depth.astype(np.uint32).view(np.int32)]).astype(np.int32)
    return torch.from_numpy(cols), torch.from_numpy(cum.astype(np.int64))


def _grid_rows(rng, n, grid_w, grid_h, capacity, depth, zero_share=0.3):
    """K7-like rows over a whole grid_w x grid_h grid: extents inside it,
    a third of them up to the grid's full height, a share zero."""
    min_x, min_y = rng.integers(0, grid_w, n), rng.integers(0, grid_h, n)
    w = 1 + (rng.random(n) * (grid_w - min_x)).astype(np.int64)
    tall = rng.random(n) < 0.3
    h = 1 + (rng.random(n) * np.where(tall, grid_h - min_y, np.minimum(grid_h - min_y, 8)))
    h = np.where(rng.random(n) < zero_share, 0, h.astype(np.int64))
    return _rows_of(rng, w, h, min_x, min_y, capacity, depth)


def _row_order_model(cols, cum, capacity):
    """The rows that keep a slot in np's stable argsort of their uint32
    depth keys; their kept counts."""
    end = np.minimum(cum.numpy(), capacity)
    kept = end - np.concatenate([[0], end[:-1]])
    rows = np.flatnonzero(kept > 0)
    depth = cols[5].numpy().view(np.uint32)
    rows = rows[np.argsort(depth[rows], kind="stable")]
    return rows, kept[rows]


@pytest.mark.parametrize("case", ["random", "zeros_and_straddle", "equal_depths", "all_dropped"])
def test_depth_order_rows_match_numpy_model(case):
    """`depth_order` on crafted rows (its plain version on the CPU): the
    kept rows first in the stable order of their depth keys (top bits set
    in the int32 column included), each with its columns, the exclusive
    scan of the kept counts as its offset and their inclusive scan; the
    rows past them keep nothing."""
    rng = np.random.default_rng(["random", "zeros_and_straddle", "equal_depths",
                                 "all_dropped"].index(case))
    n = 3 * rk.TILE + 17
    counts = rng.integers(1, 40, n)
    depth = rng.integers(0, 2**32, n)
    capacity = 10**9
    if case == "zeros_and_straddle":
        counts[rng.random(n) < 0.6] = 0
        capacity = int(counts.sum() * 0.7)
    elif case == "equal_depths":
        depth = rng.integers(0, 3, n) * 0x7FFFFFFF
    elif case == "all_dropped":
        capacity = 0
    cols, cum = _rows(rng, n, counts, capacity, depth)
    got_cols, got_cum = rk.depth_order(cols, cum, capacity, 120, 68)
    rows, kept = _row_order_model(cols, cum, capacity)
    m = rows.shape[0]
    scan = np.cumsum(kept)
    total = int(scan[-1]) if m else 0
    assert total == min(int(cum[-1]), capacity)
    np.testing.assert_array_equal(got_cum.numpy(), np.concatenate([scan, np.full(n - m, total)]))
    want = cols.numpy()[:, rows].copy()
    want[1] = scan - kept
    np.testing.assert_array_equal(got_cols.numpy()[:, :m], want)
    assert (got_cols[1, m:] == total).all()
    if case == "zeros_and_straddle":  # one row keeps part of its count
        full = cum.numpy() - np.concatenate([[0], cum.numpy()[:-1]])
        assert int((kept < full[rows]).sum()) == 1


@pytest.mark.parametrize("grid", list(WIDE))
def test_wide_record_rows_match_numpy_model(grid):
    """`depth_order` on a grid whose word's h field is narrower than its
    height: rows drawn from a seed over the whole grid (extents up to its
    full width and height, a share keeping nothing, one straddling the
    capacity, tied depth keys) against the numpy model, columns, offsets
    and scan; rows whose h reaches the field's marker are among them, and
    every other kept row's word holds its kept count as max(w, 1) h."""
    w, h = WIDE[grid]
    gw, gh = -(-w // 16), -(-h // 16)
    assert rk.rows_wide(gw, gh)
    rng = np.random.default_rng(list(WIDE).index(grid) + 40)
    n = 2 * rk.TILE + 333
    depth = rng.integers(0, 2**32, n)
    depth[rng.random(n) < 0.2] = 0x7FFFFFFF
    cols, cum = _grid_rows(rng, n, gw, gh, 10**9, depth)
    capacity = int(cum[-1]) * 3 // 4
    cols[1] = cols[1].clamp(max=capacity)
    got_cols, got_cum = rk.depth_order(cols, cum, capacity, gw, gh)
    rows, kept = _row_order_model(cols, cum, capacity)
    m = rows.shape[0]
    scan = np.cumsum(kept)
    np.testing.assert_array_equal(got_cum.numpy()[:m], scan)
    want = cols.numpy()[:, rows].copy()
    want[1] = scan - kept
    np.testing.assert_array_equal(got_cols.numpy()[:, :m], want)
    k, word = rk.pack_rows_plain(cols, cum, capacity, gw, gh)
    marker = (1 << rk.h_bits(gw, gh)) - 1
    h_field = word >> (32 - rk.h_bits(gw, gh))
    tall = (k > 0) & (k // cols[2].to(torch.int64) >= marker)
    assert int(tall.sum()) > 100 and bool((h_field[tall] == marker).all())
    count = cum - torch.cat([cum.new_zeros(1), cum[:-1]])
    straddle = (k > 0) & (k < count)
    assert int(straddle.sum()) == 1 and bool((h_field[straddle] == marker).all())
    whole = (k > 0) & (h_field != marker)
    assert torch.equal(h_field[whole] * cols[2][whole].to(torch.int64), k[whole])


def _marked_rows(cols, cum, capacity, grid_w, grid_h) -> int:
    """Rows that keep a slot and carry the h field's all-ones marker."""
    bits = rk.h_bits(grid_w, grid_h)
    kept, word = rk.pack_rows_plain(cols, cum, capacity, grid_w, grid_h)
    return int(((kept > 0) & (word >> (32 - bits) == (1 << bits) - 1)).sum())


def _index_order_lists(name):
    """The port's index-order list (keygen without the depth order) sorted
    on the full key, as a grid past the packed word would sort it."""
    table, cam, config, thr, _rule = _case(name)
    view, proj = cam.matrices()
    tt, tcfg = convert.table_from_jax(table), convert.config_from_jax(config)
    total = int(tkg.count_live_elements(tt, view, proj, cam.position, tcfg))
    el, _ = tkg.generate_sort_elements(tt, view, proj, cam.position, tcfg, total + 1001)
    return tsort.sort_elements(el, tcfg)


@pytest.mark.parametrize("grid", list(WIDE))
def test_wide_grid_depth_first_sort_matches_jax_and_index_order(grid):
    """At the wide grids, the frame's way (K7's rows in depth order, some
    marked for their height, then the tile key: 3 passes at 17 bits where
    the grid has 2^16 tiles or more) gives JAX's (tile, depth, index)
    sorted list and ranges, and the port's index-order list on the full
    key, bit for bit."""
    je, te, config, total, capacity = _lists(grid)
    tcfg = convert.config_from_jax(config)
    num_tiles = config.num_tiles
    assert rk.rows_wide(config.grid_width, config.grid_height)
    assert len(rk.schedule(num_tiles, "tile")) == (3 if num_tiles >= 2**16 else 2)
    table, cam, *_ = _case(grid)
    view, proj = cam.matrices()
    p = tkg.keygen_kernel.project_gaussians(convert.table_from_jax(table), view, proj,
                                            cam.position, tcfg, capacity, None)
    assert _marked_rows(p.cols, p.cum, capacity, config.grid_width, config.grid_height) > 0
    js = _jax_sort(je, num_tiles=num_tiles)
    ts = tsort.sort_elements(te, tcfg, depth_ordered=True)
    index_order = _index_order_lists(grid)
    for col in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(ts, col).numpy(), _np(getattr(js, col)), col)
        assert torch.equal(getattr(ts, col), getattr(index_order, col)), col
    assert int(ts.count) == int(js.count) == total > 0
    ranges = tranges.find_ranges(ts, num_tiles)
    np.testing.assert_array_equal(ranges.numpy(), _np(_jax_ranges(js, num_tiles=num_tiles)))
    assert torch.equal(ranges, tranges.find_ranges(index_order, num_tiles))


def test_wide_frame_is_the_index_order_frame_and_the_references(monkeypatch):
    """A 4096 x 2048 frame (256 x 128 tiles, the word's h field 6 bits) of
    3,000 seeded gaussians drawn by `Renderer.draw`, its list cut at the
    capacity and rows taller than 62 tiles among those that keep a slot:
    its sorted list, ranges and image equal, bit for bit, the index-order
    frame's (keygen's index order, the full key), and its image is within
    one 8-bit step of splatbench's plain reference (docs/TOLERANCES.md),
    with the same live elements."""
    import json
    from pathlib import Path

    from splatbench import judge, reference, scene
    from vk3dgaussiansplatting_tpu_torch import SphericalHarmonicsMode
    from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable

    cfg = json.loads((Path(reference.__file__).parent / "configs"
                      / "garden30k_1080p.json").read_text())
    render = dict(cfg["render"], width=4096, height=2048, capacity_slack_per_tile=4)
    n = 3000
    fr = reference.frame_constants(render, n)
    rc = TorchConfig(**dict(render, sh_mode=SphericalHarmonicsMode(render["sh_mode"]),
                            sort_algorithm=TorchSort(render["sort_algorithm"])))
    assert tsort.depth_first(rc) and rk.rows_wide(rc.grid_width, rc.grid_height)
    cloud = scene.make_cloud(n, cfg["assumed"]["cloud"], 2**33 + 5, "cpu")
    cloud = scene.scaled(cloud, 15.0)
    cam = scene.Orbit(cfg["assumed"]["camera"], rc.width / rc.height, 16, 0.02, 3).camera(1)
    view, proj = cam.matrices()
    renderer = Renderer(rc, device="cpu")
    renderer.init_for_scene(GaussianTable(*cloud))
    assert renderer.capacity == fr.capacity
    lists = []
    real_sort = tsort.sort_elements

    def spy(*a, **k):
        lists.append(out := real_sort(*a, **k))
        return out

    monkeypatch.setattr(tsort, "sort_elements", spy)
    marked = []
    real_order = rk.depth_order

    def order(*a):
        marked.append(_marked_rows(*a))
        return real_order(*a)

    monkeypatch.setattr(rk, "depth_order", order)
    depth_first = renderer.draw(cam)
    monkeypatch.setattr(tsort, "depth_first", lambda config: False)
    index_order = renderer.draw(cam)
    assert len(marked) == 1 and marked[0] > 5, marked  # rows taller than the h field's 62 tiles
    (a, b) = lists
    assert a.depth is None and b.depth is not None
    assert torch.equal(a.tile, b.tile) and torch.equal(a.index, b.index)
    assert torch.equal(tranges.find_ranges(a, rc.num_tiles), tranges.find_ranges(b, rc.num_tiles))
    assert torch.equal(depth_first.image, index_order.image)
    assert torch.equal(depth_first.image_u8, index_order.image_u8)
    ref_img, _p, s, _rows = reference.render(cloud, view, proj, cam.position, fr)
    assert int(depth_first.num_elements) == s.live > 0
    got = judge.compare(depth_first.image_u8, ref_img)
    assert got["max_step"] <= 1, got
    assert depth_first.image_u8[..., :3].any()


def test_key_schedules():
    """The tile key: bit_length(num_tiles) bits, 2 passes at 720p and
    1080p, 1 at 64 tiles; the full key 6; the rows' depth key 4."""
    assert rk.schedule(8160, "tile") == [("tile", 0, 8), ("tile", 8, 5)]
    assert rk.schedule(3600, "tile") == [("tile", 0, 8), ("tile", 8, 4)]
    assert rk.schedule(64, "tile") == [("tile", 0, 7)]
    assert len(rk.schedule(8160)) == 6
    assert rk.schedule(0, "depth") == [("depth", s, 8) for s in (0, 8, 16, 24)]
    assert rk.planned_kernels(8160, key="tile") == 4
    assert rk.planned_kernels(8160, counted=False, key="tile") == 3
    assert rk.scratch_words(rk.TILE + 1, 8160, "tile") == (rk.HEADER_WORDS + 2 * 2 * rk.BINS
                                                           + 6 * (rk.TILE + 4))
    assert rk.ROW_TILE == rk.TILE // 2
    assert rk.depth_order_scratch_words(rk.TILE + 1) == (rk.HEADER_WORDS + 2 * 4
                                                         + 4 * 2 * rk.BINS + 6 * (rk.TILE + 4))
    with pytest.raises(ValueError, match="unknown sort key"):
        rk.schedule(8160, "index")


def test_depth_first_follows_the_sort_and_the_grid():
    """The radix sort takes the depth order up to the packed word's grid
    (2 bit_length(width) + bit_length(height) <= 31: every grid up to 8K
    UHD's 480 x 270 tiles, the native 5187 x 3361 frame's 325 x 211); the
    bitonic sort never does.  The word holds every h up to 4K UHD; past it
    (`rows_wide`) its h field is narrower."""
    for algo, width, height, want in ((TorchSort.AUTO, 1920, 1080, True),
                                      (TorchSort.XLA_SORT, 1280, 720, True),
                                      (TorchSort.AUTO, 3840, 2160, True),
                                      (TorchSort.AUTO, 5187, 3361, True),
                                      (TorchSort.AUTO, 7680, 4320, True),
                                      (TorchSort.AUTO, 8192, 8192, True),
                                      (TorchSort.BITONIC, 1920, 1080, False),
                                      (TorchSort.BITONIC, 5187, 3361, False),
                                      (TorchSort.AUTO, 16384, 16384, False),
                                      (TorchSort.AUTO, 32768, 2048, False)):
        cfg = TorchConfig(width=width, height=height, sort_algorithm=algo)
        assert tsort.depth_first(cfg) is want, (algo, width, height)
    assert all(rk.rows_pack(w, h) for w in range(1, 481) for h in range(1, 271))
    assert not any(rk.rows_wide(w, h) for w in range(1, 241) for h in range(1, 136))
    assert rk.rows_wide(325, 211) and rk.h_bits(325, 211) == 6
    assert rk.rows_wide(480, 270) and rk.h_bits(480, 270) == 5
    with pytest.raises(ValueError, match="packed word"):
        cols = torch.zeros((6, 4), dtype=torch.int32)
        rk.depth_order(cols, torch.zeros(4, dtype=torch.int64), 8, 1024, 1024)


@pytest.mark.parametrize("algo", ["auto", "bitonic", "capped"])
def test_frame_paths_take_the_depth_order(algo, monkeypatch):
    """A drawn frame calls `depth_order` once and sorts on the tile key on
    the radix path (uncapped and temporal capped), and neither on the
    bitonic path."""
    cfg = TorchConfig(width=64, height=48, capacity_slack_per_tile=16,
                      sort_algorithm=TorchSort.BITONIC if algo == "bitonic" else TorchSort.AUTO,
                      capacity_pow_two=True)
    if algo == "capped":
        cfg = dataclasses.replace(cfg, blend_depth_cap=384, blend_cap_max=4096)
    calls = {"depth_order": 0, "keys": []}
    real_order, real_plain = rk.depth_order, tsort.sort_elements_radix_plain

    def order(*a, **k):
        calls["depth_order"] += 1
        return real_order(*a, **k)

    def plain(*a, **k):
        calls["keys"].append(k.get("key"))
        return real_plain(*a, **k)

    monkeypatch.setattr(rk, "depth_order", order)
    monkeypatch.setattr(tsort, "sort_elements_radix_plain", plain)
    scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
    scene.init()
    scene.camera.set_aspect(cfg.aspect)
    r = Renderer(cfg, device="cpu")
    r.init_for_scene(scene.gaussians())
    out = r.draw(scene.camera)
    assert int(out.num_elements) > 0
    radix = algo != "bitonic"
    assert calls == {"depth_order": int(radix), "keys": ["tile"] if radix else []}


def _small_scene(cfg):
    scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
    scene.init()
    scene.camera.set_aspect(cfg.aspect)
    return scene


@pytest.mark.parametrize("path", ["uncapped", "static_capped", "temporal_capped", "chained",
                                  "bitonic"])
def test_sorted_depth_only_where_it_is_read(path, monkeypatch):
    """The uncapped radix frame sorts (tile, index) alone: its sorted list
    has no depth, and its image equals, bit for bit, the image of the same
    frame whose sort keeps three columns.  The capped frames (static cap,
    temporal caps, the chained plan), which read the sorted depth, and the
    bitonic frame get a depth column."""
    cfg = TorchConfig(width=64, height=48, capacity_slack_per_tile=16,
                      sort_algorithm=TorchSort.BITONIC if path == "bitonic" else TorchSort.AUTO,
                      capacity_pow_two=True)
    if path in ("static_capped", "temporal_capped", "chained"):
        cfg = dataclasses.replace(cfg, blend_depth_cap=384, blend_cap_max=4096)
    sorted_lists = []
    real_sort = tsort.sort_elements

    def spy(*a, **k):
        out = real_sort(*a, **k)
        sorted_lists.append(out)
        return out

    monkeypatch.setattr(tsort, "sort_elements", spy)
    scene = _small_scene(cfg)
    r = Renderer(cfg, device="cpu")
    r.init_for_scene(scene.gaussians())
    view, proj = scene.camera.matrices()
    args = (r.table, view, proj, scene.camera.position)
    if path in ("uncapped", "static_capped"):
        out = pipeline.render_frame(*args, config=cfg, capacity=r.capacity)
    elif path == "chained":
        pipeline.ChainedTemporalPlan(cfg, r.capacity, device="cpu").frame(*args)
    else:
        out = r.draw(scene.camera)
    (el,) = sorted_lists
    assert int(el.count) > 0
    if path != "uncapped":
        assert el.depth is not None and el.depth.shape == el.tile.shape
        return
    assert el.depth is None
    three, ranges, frame = pipeline._sorted_frame(*args, cfg, r.capacity, None)
    assert three.depth is not None
    assert torch.equal(el.tile, three.tile) and torch.equal(el.index, three.index)
    image = tblend.blend_tiles(three, ranges, frame, cfg)
    assert torch.equal(out.image, image)
    assert out.image_u8[..., :3].any()


# ---------------------------------------------------------------- the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depth order and the radix sort are CUDA kernels "
                    "with no CPU mode")
    rk.check_kernel_config()


def _card_rows(rng, n, capacity, zero_share):
    """K7-like rows on the card at garden's grid (120 x 68 tiles): counts of
    1-40 tiles (a share zero), random depth keys."""
    counts = rng.integers(1, 41, n)
    counts[rng.random(n) < zero_share] = 0
    cols, cum = _rows(rng, n, counts, capacity, rng.integers(0, 2**32, n))
    return cols.cuda(), cum.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["garden", "garden_over_capacity", "train7k", "small"])
def test_depth_order_kernel_matches_plain(case):
    """The row order's kernels against `depth_order_plain` (on the card),
    bit for bit on the kept rows' columns, every offset and the scan, at
    garden's 5,834,784 rows and capacity 14,190,624 (below and above the
    total), train7k's 559,263 rows, and one partition's rows; five runs
    equal."""
    _needs_card()
    rng = np.random.default_rng(["garden", "garden_over_capacity", "train7k",
                                 "small"].index(case))
    n, capacity, zero_share = {"garden": (5_834_784, 14_190_624, 0.7),
                               "garden_over_capacity": (5_834_784, 14_190_624, 0.2),
                               "train7k": (559_263, 4_245_663, 0.4),
                               "small": (rk.TILE - 5, 10**6, 0.3)}[case]
    cols, cum = _card_rows(rng, n, capacity, zero_share)
    got = rk.depth_order(cols, cum, capacity, 120, 68)
    want = rk.depth_order_plain(cols, cum, capacity)
    end = cum.clamp(max=capacity)
    m = int((torch.diff(end, prepend=end.new_zeros(1)) > 0).sum())
    if case == "garden_over_capacity":
        assert int(cum[-1]) > capacity
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][:, :m], want[0][:, :m])
    assert torch.equal(got[0][1], want[0][1])
    for _ in range(4):
        again = rk.depth_order(cols, cum, capacity, 120, 68)
        assert torch.equal(again[1], got[1]) and torch.equal(again[0][:, :m], got[0][:, :m])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["garden", "train7k", "64_tiles"])
def test_tile_key_sort_matches_plain(case):
    """The tile-key sort against its plain version and the stable
    torch.sort on the tile, bit for bit: garden's 13,062,311 live of
    14,190,624 slots at 8,160 tiles, train7k's 3,487,911 of 4,245,663 at
    3,600, and a one-pass key (64 tiles); with and without the
    permutation."""
    _needs_card()
    num_tiles, e, live = {"garden": (8160, 14_190_624, 13_062_311),
                          "train7k": (3600, 4_245_663, 3_487_911),
                          "64_tiles": (64, 300_000, 290_001)}[case]
    rng = np.random.default_rng(num_tiles)
    cols = [np.full(e, SENTINEL, np.int64) for _ in range(3)]
    cols[0][:live] = rng.integers(0, num_tiles, live)
    cols[1][:live] = np.sort(rng.integers(0, 1 << 32, live))
    cols[2][:live] = rng.integers(0, 1 << 23, live)
    el = tkg.SortElements(*(torch.from_numpy(c).cuda() for c in cols),
                          torch.tensor(live, device="cuda"))
    for with_perm in (False, True):
        kernels = _build.LAUNCHES["radix_kernels"]
        got = rk.radix_sort(*el[:3], el.count, num_tiles, with_perm=with_perm, key="tile")
        assert _build.LAUNCHES["radix_kernels"] - kernels == rk.planned_kernels(num_tiles,
                                                                                key="tile")
        plain = tsort.sort_elements_radix_plain(el, num_tiles, with_perm=with_perm, key="tile")
        plain_cols = [*plain[0][:3], plain[1]] if with_perm else list(plain[:3])
        tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
        _, perm = torch.sort(tile, stable=True)
        stable = [el.tile[perm], el.depth[perm], el.index[perm], perm]
        for ref in (plain_cols, stable):
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["garden", "garden_no_count", "train7k", "train7k_no_count"])
def test_two_column_sort_matches_plain_and_three_columns(case):
    """The tile-key sort without the depth column on the card: tile and
    index bit for bit with its plain version and with the kernel's
    three-column sort, at garden's 13,062,311 live of 14,190,624 slots on
    8,160 tiles and train7k's 3,487,911 of 4,245,663 on 3,600, with and
    without the count (then with sentinels between live slots); with and
    without the permutation; the depth None, one "radix_two_column" a sort."""
    _needs_card()
    num_tiles, e, live = {"garden": (8160, 14_190_624, 13_062_311),
                          "train7k": (3600, 4_245_663, 3_487_911)}[case.split("_")[0]]
    counted = not case.endswith("no_count")
    rng = np.random.default_rng(e)
    cols = [np.full(e, SENTINEL, np.int64) for _ in range(3)]
    cols[0][:live] = rng.integers(0, num_tiles, live)
    cols[1][:live] = np.sort(rng.integers(0, 1 << 32, live))
    cols[2][:live] = rng.integers(0, 1 << 23, live)
    if not counted:
        dead = rng.random(e) < 0.1
        for c in cols:
            c[dead] = SENTINEL
    el = tkg.SortElements(*(torch.from_numpy(c).cuda() for c in cols),
                          torch.tensor(live, device="cuda") if counted else None)
    two = el._replace(depth=None)
    for with_perm in (False, True):
        before = _build.LAUNCHES.copy()
        got = rk.radix_sort(two.tile, None, two.index, two.count, num_tiles,
                            with_perm=with_perm, key="tile")
        assert _build.LAUNCHES["radix_two_column"] - before["radix_two_column"] == 1
        assert (_build.LAUNCHES["radix_kernels"] - before["radix_kernels"]
                == rk.planned_kernels(num_tiles, counted, key="tile"))
        three = rk.radix_sort(*el[:3], el.count, num_tiles, with_perm=with_perm, key="tile")
        assert _build.LAUNCHES["radix_two_column"] - before["radix_two_column"] == 1
        plain = tsort.sort_elements_radix_plain(two, num_tiles, with_perm=with_perm, key="tile")
        plain_cols = [*plain[0][:3], plain[1]] if with_perm else list(plain[:3])
        assert got[1] is None and plain_cols[1] is None
        for k in (0, 2, 3) if with_perm else (0, 2):
            assert torch.equal(got[k], three[k]), (case, with_perm, k)
            assert torch.equal(got[k], plain_cols[k]), (case, with_perm, k)


def _frame_launches(sort_algorithm, **cap):
    """LAUNCHES of one frame of a small scene on the card: uncapped, or
    with `cap` (blend_depth_cap, ...) the temporal capped frame."""
    cfg = TorchConfig(width=1280, height=720, capacity_slack_per_tile=32,
                      sort_algorithm=sort_algorithm, capacity_pow_two=True, **cap)
    scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
    scene.init()
    scene.camera.set_aspect(cfg.aspect)
    r = Renderer(cfg, device="cuda")
    r.init_for_scene(scene.gaussians())
    r.draw(scene.camera)
    torch.cuda.synchronize()
    before = _build.LAUNCHES.copy()
    r.draw(scene.camera)
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}, cfg


@pytest.mark.cuda
def test_launches_a_frame_on_each_path():
    """The radix path: one depth order, one radix sort on the tile key, and
    their kernels; the bitonic path: neither; the distributed frame's
    `_sort3`: the full key's kernels, no depth order."""
    _needs_card()
    got, cfg = _frame_launches(TorchSort.AUTO)
    assert got["depth_order"] == 1 and got["radix_sort"] == 1
    assert got["radix_kernels"] == (rk.DEPTH_ORDER_KERNELS
                                    + rk.planned_kernels(cfg.num_tiles, key="tile"))
    got, _ = _frame_launches(TorchSort.BITONIC)
    assert not {"depth_order", "radix_sort", "radix_kernels"} & set(got)
    before = _build.LAUNCHES.copy()
    live = 50_000
    t = torch.full((60_000,), SENTINEL, dtype=torch.int64, device="cuda")
    d, i = t.clone(), t.clone()
    t[:live] = torch.randint(0, 8160, (live,), device="cuda")
    d[:live] = torch.randint(0, 2**32, (live,), device="cuda")
    i[:live] = torch.arange(live, device="cuda")
    td._sort3(t, d, i, 8160)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["depth_order"] == before["depth_order"]
    assert (_build.LAUNCHES["radix_kernels"] - before["radix_kernels"]
            == rk.planned_kernels(8160, counted=False))


@pytest.mark.cuda
def test_wide_depth_order_on_a_native_frame(monkeypatch):
    """A native 5187 x 3361 frame on the card (325 x 211 tiles, the word's
    h field 6 bits): the depth order's kernels on the frame's own K7 rows,
    rows taller than 62 tiles among those kept, bit for bit with
    `depth_order_plain`; the frame launches one depth order, counted as
    "depth_order_wide", and the tile key's 3 scatters; its sorted list,
    ranges and image equal the index-order frame's (the full key) bit for
    bit.  A 1080p frame of the same scene counts no "depth_order_wide"."""
    _needs_card()
    table = synthetic.procedural_cloud_table(400_000, seed=7).to("cuda")
    table = dataclasses.replace(table, scale=table.scale * np.float32(2.0))
    cam_pose = CLOUD_POSE

    def renderer(width, height):
        cfg = TorchConfig(width=width, height=height, capacity_slack_per_tile=256,
                          capacity_pow_two=False)
        r = Renderer(cfg, device="cuda")
        r.init_for_scene(table)
        cam = TorchCamera(cfg.aspect)
        cam.set_position(cam_pose[0])
        cam.set_rotation(*cam_pose[1])
        return r, cam, cfg

    r, cam, cfg = renderer(5187, 3361)
    assert (cfg.grid_width, cfg.grid_height, cfg.num_tiles) == (325, 211, 68575)
    assert tsort.depth_first(cfg) and rk.rows_wide(325, 211)
    rows, lists = [], []
    real_order, real_sort = rk.depth_order, tsort.sort_elements

    def order(*a):
        rows.append(a)
        return real_order(*a)

    def spy(*a, **k):
        lists.append(out := real_sort(*a, **k))
        return out

    monkeypatch.setattr(rk, "depth_order", order)
    monkeypatch.setattr(tsort, "sort_elements", spy)
    r.draw(cam)
    torch.cuda.synchronize()
    before = _build.LAUNCHES.copy()
    depth_first = r.draw(cam)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    assert got["depth_order"] == got["depth_order_wide"] == got["radix_sort"] == 1
    assert rk.planned_kernels(cfg.num_tiles, key="tile") == 5
    assert got["radix_kernels"] == rk.DEPTH_ORDER_KERNELS + 5
    cols, cum, capacity, gw, gh = rows[-1]
    assert _marked_rows(*rows[-1]) > 300 and int(depth_first.num_elements) > 10**7
    out = rk.depth_order(cols, cum, capacity, gw, gh)
    want = rk.depth_order_plain(cols, cum, capacity)
    end = cum.clamp(max=capacity)
    m = int((torch.diff(end, prepend=end.new_zeros(1)) > 0).sum())
    assert torch.equal(out[1], want[1]) and torch.equal(out[0][1], want[0][1])
    assert torch.equal(out[0][:, :m], want[0][:, :m])
    monkeypatch.setattr(tsort, "depth_first", lambda config: False)
    index_order = r.draw(cam)
    a, b = lists[-2], lists[-1]
    assert a.depth is None and b.depth is not None
    assert torch.equal(a.tile, b.tile) and torch.equal(a.index, b.index)
    assert torch.equal(tranges.find_ranges(a, cfg.num_tiles),
                       tranges.find_ranges(b, cfg.num_tiles))
    assert torch.equal(depth_first.image, index_order.image)
    assert torch.equal(depth_first.image_u8, index_order.image_u8)
    monkeypatch.undo()
    r, cam, cfg = renderer(1920, 1080)
    r.draw(cam)
    torch.cuda.synchronize()
    before = _build.LAUNCHES.copy()
    r.draw(cam)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["depth_order"] == before["depth_order"] + 1
    assert _build.LAUNCHES["depth_order_wide"] == before["depth_order_wide"]


@pytest.mark.cuda
def test_two_column_sort_once_a_frame_on_the_uncapped_radix_path():
    """"radix_two_column": one a frame on the uncapped radix frame, none on
    the temporal capped frame, the bitonic frame and the distributed
    frame's `_sort3`."""
    _needs_card()
    got, _ = _frame_launches(TorchSort.AUTO)
    assert got["radix_two_column"] == 1 and got["radix_sort"] == 1
    got, _ = _frame_launches(TorchSort.AUTO, blend_depth_cap=384, blend_cap_max=4096)
    assert got["radix_sort"] >= 1 and "radix_two_column" not in got
    got, _ = _frame_launches(TorchSort.BITONIC)
    assert "radix_two_column" not in got
    before = _build.LAUNCHES.copy()
    t = torch.full((60_000,), SENTINEL, dtype=torch.int64, device="cuda")
    d, i = t.clone(), t.clone()
    t[:50_000] = torch.randint(0, 8160, (50_000,), device="cuda")
    d[:50_000] = torch.randint(0, 2**32, (50_000,), device="cuda")
    i[:50_000] = torch.arange(50_000, device="cuda")
    td._sort3(t, d, i, 8160)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["radix_sort"] == before["radix_sort"] + 1
    assert _build.LAUNCHES["radix_two_column"] == before["radix_two_column"]


@pytest.mark.cuda
def test_radix_kernels_have_no_spill():
    """ptxas's report of every radix kernel (the scatter's instantiations,
    the rows' prep and scan included): no spill, no stack."""
    _needs_card()
    _build.load_library()
    report = _build.library_path().with_suffix(".log").read_text()
    blocks = re.split(r"(?=Compiling entry function)", report)
    radix = [b for b in blocks if "radix" in b.split("\n")[0]]
    assert len(radix) >= 8, "the radix kernels are missing from ptxas's report"
    for b in radix:
        assert re.search(r"0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", b), b
