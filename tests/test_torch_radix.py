"""The AUTO sort's LSD radix sort (ops/sort.py `sort_elements_xla`: the
kernel csrc/radix.cu on CUDA tensors, `sort_elements_radix_plain` on CPU
tensors) against the JAX package's `sort_elements_xla` and the distributed
frame's `_sort3`.

On the CPU, bit for bit: the plain version against jitted JAX at 720p's,
a power of two's and 1080p's tile counts, with count 0, some and E, E not a
multiple of the kernel's block, all-equal keys, depth keys near 2^32 - 1,
and lists whose slots past the count are not all SENTINEL (every slot is
then sorted); `_sort3` on received lists with sentinels between live slots; the
plain version against a stable `torch.sort` with shuffled ids (stability
beyond JAX's id tie-break); the tile key's two-column sort (no depth
column) against the three-column sort, and the full key refusing it; the
digit schedule; the wrapper's guards; no `torch.sort` on the CPU frame.
On the card (`cuda` marker, skipped without one): the kernel against the
plain version and `torch.sort`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.parallel import dist as jd
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL, RenderConfig
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import radix_kernel as rk
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES
from vk3dgaussiansplatting_tpu_torch.ops.keygen import SortElements
from vk3dgaussiansplatting_tpu_torch.parallel import dist as td
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic

torch.set_num_threads(1)

_jax_sort = jax.jit(jsort.sort_elements_xla, static_argnames=("num_tiles",))
_jax_sort3 = jax.jit(jd._sort3)
COLS = ("tile", "depth", "index")
E = 3 * rk.TILE + 1234  # not a multiple of the kernel's block


def _keygen_list(rng, num_tiles, e, live, tile=None, depth=None):
    """A list shaped as keygen makes it: `live` slots, then SENTINEL
    triples; ids ascend in slot order."""
    cols = [np.full(e, SENTINEL, np.int64) for _ in COLS]
    cols[0][:live] = rng.integers(0, num_tiles, live) if tile is None else tile
    cols[1][:live] = rng.integers(0, 1 << 32, live) if depth is None else depth
    cols[2][:live] = np.arange(live)
    return cols


def _elements(cols, count, device="cpu"):
    t = [torch.from_numpy(np.asarray(c, np.int64)).to(device) for c in cols]
    return SortElements(*t, None if count is None else torch.tensor(count, device=device))


def _torch_sort(el: SortElements, num_tiles: int):
    """The stable int64-key `torch.sort` the AUTO sort replaced: the
    reference order, and the permutation."""
    tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
    key, perm = torch.sort((tile << 32) | el.depth, stable=True)
    t = key >> 32
    return [torch.where(t == num_tiles, SENTINEL, t), key & 0xFFFFFFFF, el.index[perm]], perm


def _assert_cols(got, want, what):
    for name, g, w in zip(COLS, got, want):
        g, w = np.asarray(g.cpu() if torch.is_tensor(g) else g).astype(np.int64), np.asarray(w)
        assert np.array_equal(g, w.astype(np.int64)), (
            f"{what}: {name} differs at {int((g != w).sum())} of {g.size} slots")


def _check_vs_jax(cols, count, num_tiles, what):
    je = jkg.SortElements(*(jnp.asarray(c.astype(np.uint32)) for c in cols), jnp.uint32(count))
    want = _jax_sort(je, num_tiles=num_tiles)
    el = _elements(cols, count)
    got = tsort.sort_elements_xla(el, num_tiles)
    _assert_cols(got[:3], want[:3], what)
    assert got.count is el.count
    assert all(np.array_equal(x.numpy(), c) for x, c in zip(el[:3], cols)), f"{what}: input written"


def _interleaved(rng, num_tiles):
    """Live slots between and past the count (the bitonic tests' lists,
    count = the live slots): every slot is sorted, as JAX sorts them."""
    cols = _keygen_list(rng, num_tiles, E, E)
    dead = rng.random(E) < 0.3
    for c in cols:
        c[dead] = SENTINEL
    return cols, int((~dead).sum())


def _one_live_in_tail(rng, num_tiles):
    cols = _keygen_list(rng, num_tiles, E, 100)
    cols[0][E - 1], cols[1][E - 1], cols[2][E - 1] = 5, 7, 3
    return cols, 100


@pytest.mark.parametrize("num_tiles", [3600, 4096, 8160])
def test_plain_matches_jax(num_tiles):
    """720p's and 1080p's tile counts, and 4096 = 2^12, where the mapped
    SENTINEL tile needs the 13th bit; with the count bounding a SENTINEL
    tail, and with live slots past the count."""
    rng = np.random.default_rng(num_tiles)
    live = E * 3 // 5
    top = (1 << 32) - 1
    cases = {
        "count 0": (_keygen_list(rng, num_tiles, E, 0), 0),
        "count some": (_keygen_list(rng, num_tiles, E, live), live),
        "count E": (_keygen_list(rng, num_tiles, E, E), E),
        "count past E": (_keygen_list(rng, num_tiles, E, E), E + 7),
        "all-equal keys": (_keygen_list(rng, num_tiles, E, live, tile=num_tiles - 1,
                                        depth=12345), live),
        "depth near 2^32 - 1": (_keygen_list(rng, num_tiles, E, live,
                                             depth=rng.integers(top - 40, top + 1, live)), live),
        "few tiles and depths": (_keygen_list(rng, num_tiles, E, E, tile=rng.integers(0, 3, E),
                                              depth=rng.integers(0, 4, E) << 30), E),
        "slots past the count not SENTINEL": _interleaved(rng, num_tiles),
        "one live slot in the tail": _one_live_in_tail(rng, num_tiles),
    }
    for what, (cols, count) in cases.items():
        _check_vs_jax(cols, count, num_tiles, f"{num_tiles} tiles, {what}")


def _two_column_cases():
    """(num_tiles, columns, count) lists for the two-column sort: live
    prefixes bounded by the count, SENTINEL tails, tails that are not all
    SENTINEL (a tile, an index, or the depth alone), E = 0 and E = 1, E not
    a multiple of the partition, no count."""
    rng = np.random.default_rng(27)
    live = E * 3 // 5
    depth_only = _keygen_list(rng, 8160, E, live)
    depth_only[1][E - 3] = 99  # the depth column alone is live past the count
    index_only = _keygen_list(rng, 3600, E, live)
    index_only[2][live + 5] = 4
    no_count, _ = _interleaved(rng, 8160)
    return {
        "prefix, 1080p": (8160, _keygen_list(rng, 8160, E, live), live),
        "prefix, 720p": (3600, _keygen_list(rng, 3600, E, live), live),
        "prefix, 4096 tiles": (4096, _keygen_list(rng, 4096, E, live), live),
        "count 0": (8160, _keygen_list(rng, 8160, E, 0), 0),
        "count E": (8160, _keygen_list(rng, 8160, E, E), E),
        "count past E": (3600, _keygen_list(rng, 3600, E, E), E + 7),
        "prefix ends inside a partition": (8160, _keygen_list(rng, 8160, 2 * rk.TILE,
                                                              rk.TILE + 77), rk.TILE + 77),
        "tail not SENTINEL: interleaved": (8160, *_interleaved(rng, 8160)),
        "tail not SENTINEL: one live slot": (3600, *_one_live_in_tail(rng, 3600)),
        "tail not SENTINEL: an index": (3600, index_only, live),
        "tail not SENTINEL: a depth alone": (8160, depth_only, live),
        "E = 0": (8160, _keygen_list(rng, 8160, 0, 0), 0),
        "E = 1": (8160, _keygen_list(rng, 8160, 1, 1), 1),
        "E = 1, count 0": (3600, _keygen_list(rng, 3600, 1, 0), 0),
        "no count": (8160, no_count, None),
    }


@pytest.mark.parametrize("case", list(_two_column_cases()))
def test_two_column_sort_matches_three_column(case):
    """The tile key with no depth column (`sort_elements_radix_plain`, and
    `sort_elements_xla` on CPU tensors): tile and index equal the
    three-column sort's bit for bit, with and without the permutation, and
    the depth comes back None."""
    num_tiles, cols, count = _two_column_cases()[case]
    el = _elements(cols, count)
    two = el._replace(depth=None)
    for with_perm in (False, True):
        want = tsort.sort_elements_radix_plain(el, num_tiles, with_perm=with_perm, key="tile")
        for sort in (tsort.sort_elements_radix_plain, tsort.sort_elements_xla):
            got = sort(two, num_tiles, with_perm=with_perm, key="tile")
            what = f"{case}, {sort.__name__}, with_perm {with_perm}"
            if with_perm:
                assert torch.equal(got[1], want[1]), what
                got, ref = got[0], want[0]
            else:
                ref = want
            assert got.depth is None and got.count is el.count, what
            assert torch.equal(got.tile, ref.tile) and torch.equal(got.index, ref.index), what
    assert all(np.array_equal(x.numpy(), c) for x, c in zip(el[:3], cols)), f"{case}: input written"


def test_full_key_refuses_no_depth():
    """The (tile, depth) key needs the depth column: the plain version, the
    dispatch and the kernel's wrapper refuse None before anything runs."""
    cols = [torch.zeros(8, dtype=torch.int64) for _ in COLS]
    el = SortElements(cols[0], None, cols[2], torch.tensor(8))
    for sort in (tsort.sort_elements_radix_plain, tsort.sort_elements_xla):
        with pytest.raises(ValueError, match="'tile_depth' key sorts by the depth column"):
            sort(el, 100)
        with pytest.raises(ValueError, match="'tile_depth' key sorts by the depth column"):
            sort(el, 100, key="tile_depth", with_perm=True)
    with pytest.raises(ValueError, match="'tile_depth' key sorts by the depth column"):
        rk.radix_sort(cols[0], None, cols[2], el.count, 100)


def test_sort3_matches_jax():
    """`_sort3` on received lists: live slots with sentinels between them
    (no count bounds them), ids ascending in slot order within a (tile,
    depth) pair; its permutation against the stable torch.sort's."""
    rng = np.random.default_rng(3)
    for num_tiles, e in ((8160, E), (4096, 2 * rk.TILE), (3600, 999)):
        cols = _keygen_list(rng, num_tiles, e, e, depth=rng.integers(0, 50, e) << 20)
        dead = rng.random(e) < 0.4
        for c in cols:
            c[dead] = SENTINEL
        want = _jax_sort3(*(jnp.asarray(c.astype(np.uint32)) for c in cols))
        t, d, i, perm = td._sort3(*(torch.from_numpy(c) for c in cols), num_tiles)
        _assert_cols((t, d, i), want, f"_sort3 {num_tiles}")
        _ref, ref_perm = _torch_sort(_elements(cols, None), num_tiles)
        assert torch.equal(perm, ref_perm)
        assert torch.equal(i, torch.from_numpy(cols[2])[perm])


def test_plain_is_stable_with_shuffled_ids():
    """Shuffled ids and many equal (tile, depth) pairs: the plain version
    keeps slot order within a pair, as the stable torch.sort does (JAX's id
    tie-break would not), with and without the permutation."""
    rng = np.random.default_rng(4)
    for count in (E, E // 2):
        cols = _keygen_list(rng, 3600, E, count, tile=rng.integers(0, 5, count),
                            depth=rng.integers(0, 3, count))
        cols[2][:count] = rng.permutation(count)
        el = _elements(cols, count)
        want, want_perm = _torch_sort(el, 3600)
        _assert_cols(tsort.sort_elements_xla(el, 3600)[:3], want, f"count {count}")
        got, perm = tsort.sort_elements_xla(el, 3600, with_perm=True)
        _assert_cols(got[:3], want, f"count {count}, with the permutation")
        assert torch.equal(perm, want_perm)


def test_schedule():
    """8-bit digits over 32 + bit_length(num_tiles) bits, least significant
    first: 6 passes at 720p and 1080p, 7 where the key needs 49 bits; the
    kernels a sort and the scratch of the one-sweep design."""
    cfg_720, cfg_1080 = RenderConfig(width=1280, height=720), RenderConfig(width=1920, height=1080)
    assert (cfg_720.num_tiles, cfg_1080.num_tiles) == (3600, 8160)
    for num_tiles, bits, passes in ((3600, 44, 6), (8160, 45, 6), (4096, 45, 6), (4095, 44, 6),
                                    (70_000, 49, 7), (1, 33, 5)):
        sched = rk.schedule(num_tiles)
        assert rk.key_bits(num_tiles) == bits and len(sched) == passes, num_tiles
        assert [c for c, _s, _b in sched] == ["depth"] * 4 + ["tile"] * (passes - 4)
        assert [s for _c, s, _b in sched] == [0, 8, 16, 24] + [8 * k for k in range(passes - 4)]
        assert sum(b for _c, _s, b in sched) == bits
        # The setup, the histogram, then one scatter a pass.
        assert rk.planned_kernels(num_tiles) == 2 + passes
        assert rk.planned_kernels(num_tiles, counted=False) == 1 + passes
        assert passes <= rk.MAX_PASSES
    # The trap: RenderConfig.num_tile_bits counts num_tiles - 1.
    assert RenderConfig(width=1024, height=1024).num_tile_bits == 12
    assert rk.key_bits(RenderConfig(width=1024, height=1024).num_tiles) == 45
    # The header, 6 passes x 2 partitions of 256 status words, two [3, e]
    # record buffers with columns padded to 4 words.
    assert rk.TILE == 8192 and rk.HEADER_WORDS == 16 + 8 * rk.BINS
    assert rk.scratch_words(rk.TILE + 1, 8160) == (rk.HEADER_WORDS + 6 * 2 * rk.BINS
                                                   + 6 * (rk.TILE + 4))
    assert rk.scratch_words(8, 3600) == rk.HEADER_WORDS + 6 * rk.BINS + 6 * 8


def test_wrapper_guards():
    cols = [torch.zeros(8, dtype=torch.int64) for _ in COLS]
    count = torch.tensor(8)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.radix_sort(*cols, count, 100)
    for bad in (cols[1].int(), cols[1][:4], cols[1].reshape(2, 4)):
        with pytest.raises(ValueError, match=r"depth must be \[8\] int64"):
            rk.radix_sort(cols[0], bad, cols[2], count, 100)
    strided = torch.zeros(16, dtype=torch.int64)[::2]
    with pytest.raises(ValueError, match="index must be contiguous"):
        rk.radix_sort(cols[0], cols[1], strided, count, 100)
    for bad in (torch.tensor([8]), torch.tensor(8, dtype=torch.int32)):
        with pytest.raises(ValueError, match="count must be a"):
            rk.radix_sort(*cols, bad, 100)
    for num_tiles in (0, 2**31):
        with pytest.raises(ValueError, match="does not fit the sort key"):
            rk.radix_sort(*cols, count, num_tiles)
        with pytest.raises(ValueError, match="does not fit the sort key"):
            tsort.sort_elements_xla(SortElements(*cols, count), num_tiles)


def test_cpu_frame_calls_no_torch_sort():
    """The AUTO frame on the CPU sorts with the plain version: no
    torch.sort or argsort during a draw, and no kernel launch."""

    class SortCalls(torch.overrides.TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.sort, torch.Tensor.sort, torch.argsort, torch.Tensor.argsort):
                SortCalls.calls += 1
            return func(*args, **(kwargs or {}))

    cfg = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
    scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
    scene.init()
    r = Renderer(cfg, device="cpu")
    r.init_for_scene(scene.gaussians())
    launches = LAUNCHES["radix_sort"]
    with SortCalls():
        out = r.draw(scene.camera)
    assert SortCalls.calls == 0 and LAUNCHES["radix_sort"] == launches
    assert int(out.num_elements) > 0 and out.image_u8[..., :3].any()


@pytest.mark.cuda
def test_radix_kernel_on_cuda():
    """The kernel against its plain version and the stable torch.sort, bit
    for bit, with and without the permutation, its input unchanged and its
    kernels counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the radix sort is a CUDA kernel with no CPU mode")
    rk.check_kernel_config()
    rng = np.random.default_rng(11)
    for num_tiles, e, live, count in ((8160, 1, 1, 1), (8160, rk.TILE - 1, 3000, 3000),
                                      (4096, rk.TILE, rk.TILE, rk.TILE),
                                      (3600, rk.TILE + 1, 0, 0), (70_000, 1 << 20, 900_000, None),
                                      (8160, (1 << 22) + 3, 3_000_000, 3_000_000)):
        cols = _keygen_list(rng, num_tiles, e, live)
        if count is None:  # sentinels between live slots, every slot sorted
            dead = rng.random(e) < 0.3
            for c in cols:
                c[dead] = SENTINEL
        el = _elements(cols, count, device="cuda")
        before = [x.clone() for x in el[:3]]
        want, want_perm = _torch_sort(el, num_tiles)
        plain, plain_perm = tsort.sort_elements_radix_plain(el, num_tiles, with_perm=True)
        for with_perm in (False, True):
            launches, passes = LAUNCHES["radix_sort"], LAUNCHES["radix_kernels"]
            got = rk.radix_sort(*el[:3], el.count, num_tiles, with_perm=with_perm)
            torch.cuda.synchronize()
            assert LAUNCHES["radix_sort"] == launches + 1
            assert LAUNCHES["radix_kernels"] - passes == rk.planned_kernels(num_tiles, count is not None)
            what = f"E={e}, count {count}, with_perm {with_perm}"
            _assert_cols(got[:3], [x.cpu() for x in want], f"{what} vs torch.sort")
            _assert_cols(got[:3], [x.cpu() for x in plain[:3]], f"{what} vs plain")
            if with_perm:
                assert torch.equal(got[3], want_perm) and torch.equal(got[3], plain_perm), what
        assert all(torch.equal(a, b) for a, b in zip(before, el[:3])), f"E={e}: input written"
