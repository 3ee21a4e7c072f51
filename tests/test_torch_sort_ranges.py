"""Port parity: sort (ops/sort.py) and ranges (ops/ranges.py) bit-exact
against the JAX package, including a completely full list (the FindRanges
E-1 quirk) and the SENTINEL mapping around the int64 key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.core.config import RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import ranges as tranges
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)


def _elements(num_tiles, e, live, seed, depth_levels=50):
    """Slot-ordered element list: `live` live slots then sentinels.  Index
    is the slot, so ids ascend within equal (tile, depth) pairs as keygen
    guarantees; few depth levels force many ties."""
    rng = np.random.default_rng(seed)
    tile = np.full(e, SENTINEL, np.uint32)
    depth = np.full(e, SENTINEL, np.uint32)
    index = np.full(e, SENTINEL, np.uint32)
    tile[:live] = rng.integers(0, num_tiles, live)
    depth[:live] = rng.integers(0, depth_levels, live) * 85_000_000
    index[:live] = np.arange(live)
    return tile, depth, index, live


def _check(tile, depth, index, live, num_tiles):
    je = jkg.SortElements(jnp.asarray(tile), jnp.asarray(depth), jnp.asarray(index),
                          jnp.uint32(live))
    js = jax.jit(jsort.sort_elements_xla, static_argnames=("num_tiles",))(je, num_tiles=num_tiles)
    jr = jax.jit(jranges.find_ranges, static_argnames=("num_tiles",))(js, num_tiles=num_tiles)
    as64 = lambda a: torch.from_numpy(a.astype(np.int64))
    te = tkg.SortElements(as64(tile), as64(depth), as64(index), torch.tensor(live))
    ts = tsort.sort_elements_xla(te, num_tiles)
    tr = tranges.find_ranges(ts, num_tiles)
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)).astype(np.int64), name
        )
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).astype(np.int64))
    return ts, tr


@pytest.mark.parametrize(
    "num_tiles,e,live",
    [
        (64, 4096, 3000),  # sentinel tail
        (64, 4096, 4096),  # completely full: the E-1 quirk
        (8160, 20000, 20000),  # 1080p tile count, full
        (8160, 20000, 0),  # empty frame
        (70_000, 5000, 4000),  # tile ids past 16 bits: JAX's u32 branch
    ],
)
def test_sort_and_ranges_match_jax(num_tiles, e, live):
    tile, depth, index, live = _elements(num_tiles, e, live, seed=num_tiles + live)
    ts, tr = _check(tile, depth, index, live, num_tiles)
    assert (ts.tile[live:] == SENTINEL).all()
    assert (ts.depth[live:] == SENTINEL).all()


def test_full_list_boundary_quirk():
    """Last two slots in different tiles of a full list: neither boundary
    side is written (the reference never examines it)."""
    num_tiles, e = 16, 256
    tile = np.sort(np.random.default_rng(0).integers(0, 15, e)).astype(np.uint32)
    tile[-1] = 15
    depth = np.zeros(e, np.uint32)
    index = np.arange(e, dtype=np.uint32)
    _ts, tr = _check(tile, depth, index, e, num_tiles)
    assert tr[15].tolist() == [0, e - 1]


def test_keygen_sort_ranges_chain_matches_jax():
    config = RenderConfig(width=128, height=128, capacity_slack_per_tile=32,
                          sort_algorithm=SortAlgorithm.XLA_SORT, expansion_method="repeat")
    from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn

    scene = jsyn.TestSortScene(aspect=config.aspect)
    scene.init()
    table = scene.gaussians()
    view, proj = scene.camera.matrices()
    cap = config.sort_capacity(table.position.shape[0])

    @jax.jit
    def jchain(t, v, p, c):
        el, _ = jkg.generate_sort_elements(t, v, p, c, config, cap)
        el = jsort.sort_elements(el, config)
        return el, jranges.find_ranges(el, config.num_tiles)

    je, jr = jchain(jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
                    jnp.asarray(scene.camera.position))
    tconfig = convert.config_from_jax(config)
    te, _ = tkg.generate_sort_elements(convert.table_from_jax(table), view, proj,
                                       scene.camera.position, tconfig, cap)
    te = tsort.sort_elements(te, tconfig)
    tr = tranges.find_ranges(te, tconfig.num_tiles)
    np.testing.assert_array_equal(te.index.numpy(), np.asarray(je.index).astype(np.int64))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).astype(np.int64))

