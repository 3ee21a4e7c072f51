"""The bitonic sort tier (ops/bitonic.py, csrc/bitonic.cu) against the JAX
package's `sort_elements_bitonic`.

On the CPU: the plain version bit for bit with jitted JAX and with the
stable tier (`sort_elements_xla`), the power-of-two guard in both packages,
the kernel's launch schedule (`bitonic_kernel.schedule`) run as a numpy
model of its passes, the bitonic frame against JAX's (elements and ranges
bit-exact, images ±1 8-bit per channel) and against the port's AUTO frame
bit for bit, and `RenderConfig.with_resolution`.  On the card (`cuda`
marker, skipped without one): the kernel against the plain version and the
stable tier at E = 1, 2, B/2, B, 2B and 2^20, its input left as it was
(tests/test_torch_bitonic_fused.py holds it at more sizes and groups).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu import pipeline as jpipe
from vk3dgaussiansplatting_tpu.core import config as jcfg
from vk3dgaussiansplatting_tpu.ops import bitonic as jbit
from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import ranges as jranges
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL, RenderConfig, SortAlgorithm
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as tbit
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import ranges as tranges
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import bitonic_kernel as tbk
from vk3dgaussiansplatting_tpu_torch.pipeline import render_frame
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

NUM_TILES = 100
JCONFIG = jcfg.RenderConfig(width=192, height=96, capacity_slack_per_tile=32,
                            sort_algorithm=jcfg.SortAlgorithm.BITONIC)


def _random_elements(rng, e):
    """tests/test_sort_tiers.py's generator: ~30% dead (SENTINEL) slots,
    ids ascending in slot order, plus a quarter of the slots copying another
    slot's (tile, depth) pair."""
    tile = rng.integers(0, NUM_TILES, e).astype(np.uint32)
    depth = rng.integers(0, 1 << 20, e).astype(np.uint32)
    src, dst = rng.integers(0, e, (2, e // 4))
    tile[dst], depth[dst] = tile[src], depth[src]
    idx = np.arange(e, dtype=np.uint32)
    dead = rng.random(e) < 0.3
    tile[dead] = SENTINEL
    depth[dead] = SENTINEL
    idx = np.where(dead, np.uint32(SENTINEL), idx)
    return tile, depth, idx


def _torch_elements(tile, depth, idx, device="cpu"):
    cols = (torch.from_numpy(x.astype(np.int64)).to(device) for x in (tile, depth, idx))
    return tkg.SortElements(*cols, torch.tensor(int((tile != SENTINEL).sum()), device=device))


def _assert_elements_equal(got, want, what):
    for name in ("tile", "depth", "index"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.equal(g.cpu(), w.cpu()), f"{what}: {name} differs at {int((g != w).sum())}"


@pytest.mark.parametrize("e", [256, 4096])
def test_plain_matches_jax_bitonic(e):
    tile, depth, idx = _random_elements(np.random.default_rng(e), e)
    je = jkg.SortElements(jnp.asarray(tile), jnp.asarray(depth), jnp.asarray(idx),
                          jnp.uint32((tile != SENTINEL).sum()))
    want = jax.jit(jbit.sort_elements_bitonic)(je)
    got = tbit.sort_elements_bitonic(_torch_elements(tile, depth, idx))
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)).astype(np.int64), name)
    assert int(got.count) == int(want.count)


def test_plain_matches_stable_tier_with_partial_sentinels():
    """2^16 slots, ids shuffled, SENTINEL in one column only on some slots:
    the stable (tile, depth) sort of the list put in id order first is the
    (tile, depth, index) order."""
    rng = np.random.default_rng(16)
    e = 1 << 16
    tile = rng.integers(0, NUM_TILES, e).astype(np.int64)
    depth = rng.integers(0, 64, e).astype(np.int64) * 67_000_000
    idx = rng.permutation(e).astype(np.int64)
    for col, share in ((tile, 0.05), (depth, 0.05), (idx, 0.02)):
        col[rng.random(e) < share] = SENTINEL
    dead = rng.random(e) < 0.2
    tile[dead] = depth[dead] = idx[dead] = SENTINEL
    el = tkg.SortElements(*(torch.from_numpy(x) for x in (tile, depth, idx)), torch.tensor(e))
    got = tbit.sort_elements_bitonic_plain(el)
    order = torch.argsort(el.index, stable=True)
    by_id = tkg.SortElements(el.tile[order], el.depth[order], el.index[order], el.count)
    _assert_elements_equal(got, tsort.sort_elements_xla(by_id, NUM_TILES), "vs the stable tier")
    lex = np.lexsort((idx, depth, tile))
    np.testing.assert_array_equal(got.index.numpy(), idx[lex])
    assert int(got.count) == e
    assert torch.equal(el.index, torch.from_numpy(idx))  # the input is not written


def test_non_power_of_two_raises_in_both_packages():
    tile, depth, idx = _random_elements(np.random.default_rng(100), 100)
    je = jkg.SortElements(jnp.asarray(tile), jnp.asarray(depth), jnp.asarray(idx), jnp.uint32(0))
    with pytest.raises(ValueError, match="power-of-two"):
        jbit.sort_elements_bitonic(je)
    with pytest.raises(ValueError, match="power-of-two"):
        tbit.sort_elements_bitonic(_torch_elements(tile, depth, idx))


# csrc/bitonic.cu's index arithmetic, restated for the numpy model.
PER_THREAD_LOG = 5  # a shared pass's thread holds 2^5 elements (kPerLog)


def slot_groups(e, lo, g):
    """[e >> g, 2^g] int64: the slots each thread of a global pass over the
    distances 2^lo .. 2^(lo+g-1) owns, by register (bitonic_global_kernel)."""
    tid = torch.arange(e >> g, dtype=torch.int64)
    base = ((tid >> lo) << (lo + g)) | (tid & ((1 << lo) - 1))
    return base[:, None] + (torch.arange(1 << g, dtype=torch.int64) << lo)


def layout_slots(block, b):
    """[threads, 32] int64: the block slots each thread of a shared pass
    holds in layout b, by register (layout_base(t, b) | u << b)."""
    t = torch.arange(block >> PER_THREAD_LOG, dtype=torch.int64)
    base = ((t >> b) << (b + PER_THREAD_LOG)) | (t & ((1 << b) - 1))
    return base[:, None] | (torch.arange(1 << PER_THREAD_LOG, dtype=torch.int64) << b)


def layout_for(x, block):
    """The layout a shared pass re-maps to when the stage at distance 2^x
    is outside its current one (layout_for)."""
    top = block.bit_length() - 1 - PER_THREAD_LOG
    if x < PER_THREAD_LOG:
        return 0
    return top - PER_THREAD_LOG * ((top - x + PER_THREAD_LOG - 1) // PER_THREAD_LOG)


def swizzle(p):
    """The shared-memory word of block slot p (swizzle)."""
    return p ^ ((p >> 5) & 31)


def _compare_exchange(key, idx, u, v, ascending):
    """The kernel's compare_exchange on register columns u and v of
    [..., n] arrays: the smaller (key, index) to u where `ascending`, the
    larger elsewhere (equal triples swap where descending)."""
    ku, kv, iu, iv = key[..., u], key[..., v], idx[..., u], idx[..., v]
    swap = ((kv < ku) | ((kv == ku) & (iv < iu))) == ascending
    key[..., u], key[..., v] = np.where(swap, kv, ku), np.where(swap, ku, kv)
    idx[..., u], idx[..., v] = np.where(swap, iv, iu), np.where(swap, iu, iv)


def _register_stage(key, idx, slots, k, m):
    """One stage at register bit m: register u against u | 1 << m, each
    pair's direction from its lower slot's bit k."""
    n = key.shape[-1]
    u = np.array([r for r in range(n) if not r >> m & 1])
    _compare_exchange(key, idx, u, u | 1 << m, (slots[..., u] & k) == 0)


def _shared_pass(key, idx, stages, block):
    """A shared pass in numpy as the kernel runs it: each block's registers
    [threads, 32] in the coalesced layout, re-mapped through the block
    (`layout_slots`, `layout_for`) when a stage's distance leaves the
    layout, the all-ones padding of a lone block shorter than `block`."""
    e = key.shape[0]
    n = min(e, block)
    nb = e // n
    ones = np.iinfo(np.uint64).max
    bk = np.full((nb, block), ones, np.uint64)
    bi = np.full((nb, block), np.uint32(SENTINEL), np.uint32)
    bk[:, :n], bi[:, :n] = key.reshape(nb, n), idx.reshape(nb, n)
    top = block.bit_length() - 1 - PER_THREAD_LOG
    b, slots = top, layout_slots(block, top).numpy()
    rk, ri = bk[:, slots], bi[:, slots]
    base = np.arange(nb, dtype=np.int64)[:, None, None] * block
    for k, j in stages:
        x = j.bit_length() - 1
        assert 2 * j <= block, "a shared pass's pair leaves its block"
        if not b <= x < b + PER_THREAD_LOG:
            bk[:, slots], bi[:, slots] = rk, ri
            b = layout_for(x, block)
            slots = layout_slots(block, b).numpy()
            rk, ri = bk[:, slots], bi[:, slots]
        _register_stage(rk, ri, base + slots, k, x - b)
    bk[:, slots], bi[:, slots] = rk, ri
    return bk[:, :n].reshape(-1), bi[:, :n].reshape(-1)


def _run_schedule(tile, depth, idx, block, group=tbk.GROUP):
    """csrc/bitonic.cu's passes in numpy, compared on the packed
    (tile << 32 | depth, index) as the kernels compare them: XOR pairs
    ascending where slot & k == 0; each global pass on its threads'
    register groups (`slot_groups`: all of the pass's stages inside one
    thread's row), each shared pass through its layouts (`_shared_pass`)."""
    key = (tile.astype(np.uint64) << np.uint64(32)) | depth.astype(np.uint64)
    idx = idx.astype(np.uint32)
    e = key.shape[0]
    for kind, stages in tbk.schedule(e, block, group):
        if kind != "global":
            key, idx = _shared_pass(key, idx, stages, block)
            continue
        lo = stages[-1][1].bit_length() - 1
        g = len(stages)
        assert g <= group and all(j == stages[0][1] >> s for s, (_k, j) in enumerate(stages))
        slots = slot_groups(e, lo, g).numpy()
        rk, ri = key[slots], idx[slots]
        for k, j in stages:
            _register_stage(rk, ri, slots, k, j.bit_length() - 1 - lo)
        key[slots], idx[slots] = rk, ri
    return [x.astype(np.int64) for x in (key >> np.uint64(32), key & np.uint64(0xFFFFFFFF), idx)]


def test_kernel_schedule_sorts():
    """The launch schedule sorts and takes 30 launches at 2^24 slots
    (garden's bitonic capacity), 26 at 2^23 (105 and 91 on the reference's
    dispatch schedule; 29 and 25 at B = 2^14 with four distances a global
    pass); at small blocks and groups and at the real BLOCK the numpy model
    of its passes equals the plain version bit for bit."""
    assert [tbk.planned_passes(1 << k) for k in (0, 1, 13, 14, 18, 19, 23, 24)] == [
        1, 1, 1, 3, 11, 14, 26, 30]
    assert [tbk.planned_passes(1 << k, 1 << 14, 4) for k in (23, 24)] == [25, 29]
    assert tbk.planned_passes(1 << 24, group=4) == 33
    rng = np.random.default_rng(3)
    for block, group, sizes in ((32, 1, (1, 2, 32, 256)), (64, 3, (1024,)), (128, 5, (1 << 14,)),
                                (tbk.BLOCK, tbk.GROUP, (1024, 1 << 16))):
        for e in sizes:
            tile, depth, idx = _random_elements(rng, e)
            want = tbit.sort_elements_bitonic_plain(_torch_elements(tile, depth, idx))
            got = _run_schedule(tile, depth, idx, block, group)
            for name, g in zip(("tile", "depth", "index"), got):
                np.testing.assert_array_equal(g, getattr(want, name).numpy(),
                                              f"{block} {group} {e} {name}")


def _scene(name):
    """(JAX table, camera): the simple fixture, or a 2,048-gaussian cloud
    scaled to cover several tiles (tests/test_torch_kernel_redesign.py's)."""
    if name == "simple":
        scene = jsyn.SimpleTestGaussiansScene(aspect=JCONFIG.aspect)
        scene.init()
        return scene.gaussians(), scene.camera
    cam = Camera(JCONFIG.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    table = jsyn.procedural_cloud_table(2048, seed=11)
    return dataclasses.replace(table, scale=table.scale * np.float32(6.0)), cam


@pytest.mark.parametrize("name", ["simple", "cloud"])
def test_bitonic_frame_matches_jax(name):
    table, cam = _scene(name)
    view, proj = cam.matrices()
    cap = JCONFIG.sort_capacity(table.position.shape[0])
    assert cap & (cap - 1) == 0
    jargs = (jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
             jnp.asarray(cam.position))

    @jax.jit
    def jchain(t, v, p, c):
        el, _ = jkg.generate_sort_elements(t, v, p, c, JCONFIG, cap)
        el = jsort.sort_elements(el, JCONFIG)
        return el, jranges.find_ranges(el, JCONFIG.num_tiles)

    je, jr = jchain(*jargs)
    want = jpipe.render_frame(*jargs, config=JCONFIG, capacity=cap, use_pallas_blend=False)

    config = convert.config_from_jax(JCONFIG)
    ttable = convert.table_from_jax(table)
    te, _ = tkg.generate_sort_elements(ttable, view, proj, cam.position, config, cap)
    te = tsort.sort_elements(te, config)
    for field in ("tile", "depth", "index", "count"):
        np.testing.assert_array_equal(getattr(te, field).numpy(),
                                      np.asarray(getattr(je, field)).astype(np.int64), field)
    np.testing.assert_array_equal(tranges.find_ranges(te, config.num_tiles).numpy(),
                                  np.asarray(jr).astype(np.int64))

    got = render_frame(ttable, view, proj, cam.position, config=config, capacity=cap)
    g, w = got.image_u8.numpy().astype(np.int32), np.asarray(want.image_u8).astype(np.int32)
    for ch in range(3):
        assert np.abs(g[..., ch] - w[..., ch]).max() <= 1, f"channel {ch}"
        assert g[..., ch].sum() > 0, f"channel {ch} is empty"
    auto = render_frame(ttable, view, proj, cam.position,
                        config=dataclasses.replace(config, sort_algorithm=SortAlgorithm.AUTO),
                        capacity=cap)
    assert torch.equal(got.image, auto.image) and torch.equal(got.image_u8, auto.image_u8)


def test_with_resolution_keeps_other_fields():
    cfg = RenderConfig(sort_algorithm=SortAlgorithm.BITONIC, capacity_slack_per_tile=32,
                       blend_depth_cap=384, capacity_pow_two=False, transmittance_stop=2e-4)
    got = cfg.with_resolution(1920, 1080)
    assert (got.width, got.height, got.num_tiles) == (1920, 1080, 8160)
    for f in dataclasses.fields(RenderConfig):
        if f.name not in ("width", "height"):
            assert getattr(got, f.name) == getattr(cfg, f.name), f.name
    j = jcfg.RenderConfig(sort_algorithm=jcfg.SortAlgorithm.BITONIC, capacity_slack_per_tile=32,
                          blend_depth_cap=384, capacity_pow_two=False, transmittance_stop=2e-4)
    assert convert.config_from_jax(j.with_resolution(1920, 1080)) == got


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bitonic sort is a CUDA kernel with no CPU mode")


@pytest.mark.cuda
def test_bitonic_kernel_on_cuda():
    """Through sort_elements_bitonic, on columns that are strided views of
    one [E, 3] tensor (the wrapper copies them to contiguous columns)."""
    _needs_card()
    rng = np.random.default_rng(5)
    for e in (1, 2, tbk.BLOCK // 2, tbk.BLOCK, 2 * tbk.BLOCK, 1 << 20):
        dense = _torch_elements(*_random_elements(rng, e), device="cuda")
        rows = torch.stack(dense[:3], dim=1)
        el = tkg.SortElements(rows[:, 0], rows[:, 1], rows[:, 2], dense.count)
        assert not el.tile.is_contiguous() or e == 1
        before = [x.clone() for x in el[:3]]
        launches, passes = tbk.LAUNCHES, tbk.PASSES
        got = tbit.sort_elements_bitonic(el)
        torch.cuda.synchronize()
        assert tbk.LAUNCHES == launches + 1
        assert tbk.PASSES - passes == tbk.planned_passes(e)
        _assert_elements_equal(got, tbit.sort_elements_bitonic_plain(el), f"E={e} vs plain")
        _assert_elements_equal(got, tsort.sort_elements_xla(el, NUM_TILES), f"E={e} vs stable")
        assert int(got.count) == int(el.count)
        assert all(torch.equal(a, b) for a, b in zip(before, el[:3])), f"E={e}: input written"
