"""The one-sweep radix sort's design (csrc/radix.cu): its plain counting
pass at the kernel's partition, warp and digit constants, its status
words, and, on the card, the kernel run repeatedly and back to back.

On the CPU: `ops/sort._counting_pass` against the stable argsort of the
digit on crafted digits (all equal, an empty bin, a partial last
partition) and the plain sort with a live prefix ending inside a
partition; the plain version against jitted JAX's `sort_elements_xla` at
1080p's tile count over many partitions, and `_sort3` with the
permutation; the wrapper's slot guard and the status word's capacity; a
numpy model of the decoupled look-back in a random completion order.  On
the card (`cuda` marker, skipped without one): the kernel five times on
one list and on two lists back to back, bit for bit with the plain
version and the stable `torch.sort`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops import keygen as jkg
from vk3dgaussiansplatting_tpu.ops import sort as jsort
from vk3dgaussiansplatting_tpu.parallel import dist as jd
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import radix_kernel as rk
from vk3dgaussiansplatting_tpu_torch.ops.keygen import SortElements
from vk3dgaussiansplatting_tpu_torch.parallel import dist as td

torch.set_num_threads(1)

_jax_sort = jax.jit(jsort.sort_elements_xla, static_argnames=("num_tiles",))
_jax_sort3 = jax.jit(jd._sort3)
T = rk.TILE
TILES_1080P = 8160


def _list(rng, num_tiles, e, live, dead_share=0.0):
    """`live` slots of random (tile, depth), ids in slot order, then
    SENTINEL triples; with `dead_share`, that share of the live slots made
    SENTINEL too (a received list)."""
    cols = [np.full(e, SENTINEL, np.int64) for _ in range(3)]
    cols[0][:live] = rng.integers(0, num_tiles, live)
    cols[1][:live] = rng.integers(0, 1 << 32, live)
    cols[2][:live] = np.arange(live)
    dead = rng.random(e) < dead_share
    for c in cols:
        c[dead] = SENTINEL
    return cols


def _elements(cols, count, device="cpu"):
    t = [torch.from_numpy(np.asarray(c, np.int64)).to(device) for c in cols]
    return SortElements(*t, None if count is None else torch.tensor(count, device=device))


def _torch_sort(el: SortElements, num_tiles: int):
    """The stable int64-key torch.sort: the reference order and permutation."""
    tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
    key, perm = torch.sort((tile << 32) | el.depth, stable=True)
    t = key >> 32
    return [torch.where(t == num_tiles, SENTINEL, t), key & 0xFFFFFFFF, el.index[perm]], perm


def _stable_dest(digit: torch.Tensor) -> torch.Tensor:
    """Each slot's place in the stable order of its digit."""
    dest = torch.empty_like(digit)
    dest[torch.argsort(digit, stable=True)] = torch.arange(digit.shape[0])
    return dest


@pytest.mark.parametrize("case", ["all equal", "an empty bin", "partial last partition",
                                  "prefix ends inside a partition"])
def test_counting_pass_crafted(case):
    """The plain counting pass at the kernel's constants (TILE-slot
    partitions of 12 warps x 16 rounds) gives each slot its stable place."""
    rng = np.random.default_rng(len(case))
    if case == "prefix ends inside a partition":
        # The count bound: the sorted prefix ends 300 slots into the second
        # partition; the tail comes out SENTINEL.
        cols = _list(rng, TILES_1080P, 3 * T, T + 300)
        el = _elements(cols, T + 300)
        want, want_perm = _torch_sort(el, TILES_1080P)
        got, perm = tsort.sort_elements_radix_plain(el, TILES_1080P, with_perm=True)
        assert all(torch.equal(g, w) for g, w in zip(got[:3], want))
        assert torch.equal(perm, want_perm)
        return
    n = {"all equal": 3 * T + 17, "an empty bin": 2 * T + 5,
         "partial last partition": 2 * T + 1000}[case]
    if case == "all equal":
        digit = torch.full((n,), 200, dtype=torch.int64)
    elif case == "an empty bin":
        digit = torch.from_numpy(rng.integers(0, rk.BINS - 1, n))
        digit[digit >= 7] += 1  # bin 7 stays empty
    else:
        # Few bins, long runs: ranks carry across rounds and warps.
        digit = torch.from_numpy(rng.integers(0, 3, n) * 100)
    dest = tsort._counting_pass(digit)
    assert torch.equal(dest, _stable_dest(digit)), case


def test_plain_matches_jax_1080p_partitions():
    """1080p's tile count (45-bit keys, 6 passes) over 40 partitions, the
    live prefix ending inside the last live one: the plain version against
    jitted JAX bit for bit, its input unchanged."""
    rng = np.random.default_rng(12)
    e, live = 40 * T + 77, 33 * T + 1234
    cols = _list(rng, TILES_1080P, e, live)
    je = jkg.SortElements(*(jnp.asarray(c.astype(np.uint32)) for c in cols), jnp.uint32(live))
    want = _jax_sort(je, num_tiles=TILES_1080P)
    el = _elements(cols, live)
    got = tsort.sort_elements_xla(el, TILES_1080P)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    assert all(np.array_equal(x.numpy(), c) for x, c in zip(el[:3], cols))


def test_sort3_with_perm_matches_jax():
    """`_sort3` over every slot of a received list spanning 5 partitions,
    with the permutation: against jitted JAX and the stable torch.sort."""
    rng = np.random.default_rng(13)
    cols = _list(rng, TILES_1080P, 4 * T + 99, 4 * T + 99, dead_share=0.35)
    cols[1][cols[1] != SENTINEL] >>= 26  # many equal (tile, depth) pairs
    want = _jax_sort3(*(jnp.asarray(c.astype(np.uint32)) for c in cols))
    t, d, i, perm = td._sort3(*(torch.from_numpy(c) for c in cols), TILES_1080P)
    for g, w in zip((t, d, i), want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    _ref, ref_perm = _torch_sort(_elements(cols, None), TILES_1080P)
    assert torch.equal(perm, ref_perm)


def test_slot_guard_and_status_capacity():
    """Lists of 2^30 slots or more are refused before anything is
    allocated; below that the largest count and either flag fit one 32-bit
    status word and read back; the module's copies of the kernel's
    constants agree with each other."""
    huge = torch.zeros(1, dtype=torch.int64).expand(rk.MAX_SLOTS)
    with pytest.raises(ValueError, match="status words' 30-bit counts"):
        rk.radix_sort(huge, huge, huge, None, TILES_1080P)
    # One slot fewer passes the guard and stops at the next check.
    below = huge[:-1]
    with pytest.raises(ValueError, match="must be contiguous"):
        rk.radix_sort(below, below, below, None, TILES_1080P)
    aggregate, inclusive = 1 << rk.STATUS_COUNT_BITS, 2 << rk.STATUS_COUNT_BITS
    for flag in (aggregate, inclusive):
        word = np.uint32(flag | (rk.MAX_SLOTS - 1))
        assert int(word) >> rk.STATUS_COUNT_BITS == flag >> rk.STATUS_COUNT_BITS
        assert int(word) & (rk.MAX_SLOTS - 1) == rk.MAX_SLOTS - 1
    cfg = rk.python_config()
    assert cfg["threads"] * cfg["items"] == rk.TILE == 6144
    assert rk.key_bits((1 << 31) - 1) <= cfg["max_passes"] * cfg["digit_bits"]
    assert cfg["header_words"] % 4 == 0  # the status words start 16 B aligned


def _lookback(status, part, b, run):
    """csrc/radix.cu's look-back for bin b of partition `part` over this
    pass's status words: AGGREGATE counts summed back to an INCLUSIVE one;
    returns the exclusive prefix, or None where a predecessor has not
    published (the kernel spins there)."""
    aggregate, inclusive = 1 << rk.STATUS_COUNT_BITS, 2 << rk.STATUS_COUNT_BITS
    excl = 0
    for k in range(part - 1, -1, -1):
        s = int(status[k, b])
        if s < aggregate:
            return None
        excl += s & (aggregate - 1)
        if s >= inclusive:
            break
    status[part, b] = inclusive | (excl + run)
    return excl


def test_lookback_model_in_any_order():
    """The status protocol in a numpy model: partitions take tickets in
    order but publish and look back in a random interleaving, with counts
    that sum to just under 2^30; every partition's prefix is the exact
    sum of its predecessors' counts, and no word's count reaches the
    flag bits."""
    rng = np.random.default_rng(14)
    parts, bins = 50, 4
    counts = rng.integers(0, (rk.MAX_SLOTS - 1) // parts, (parts, bins))
    aggregate, inclusive = 1 << rk.STATUS_COUNT_BITS, 2 << rk.STATUS_COUNT_BITS
    status = np.zeros((parts, bins), np.uint32)
    want = np.cumsum(counts, 0) - counts
    published = np.zeros(parts, bool)
    got = np.full((parts, bins), -1, np.int64)
    waiting = []
    for step in range(10_000):
        if not published.all() and (not waiting or rng.random() < 0.5):
            p = int(np.flatnonzero(~published)[0]) if rng.random() < 0.7 else None
            if p is not None:
                published[p] = True
                for b in range(bins):
                    status[p, b] = (inclusive if p == 0 else aggregate) | int(counts[p, b])
                    if p == 0:
                        got[0, b] = 0
                    else:
                        waiting.append((p, b))
        if waiting:
            p, b = waiting.pop(int(rng.integers(len(waiting))))
            excl = _lookback(status, p, b, int(counts[p, b]))
            if excl is None:
                waiting.append((p, b))
            else:
                got[p, b] = excl
        if published.all() and not waiting:
            break
    assert np.array_equal(got, want)
    assert (status >> rk.STATUS_COUNT_BITS == 2).all()
    assert np.array_equal(status & (aggregate - 1), np.cumsum(counts, 0))


@pytest.mark.cuda
def test_onesweep_kernel_repeated_and_back_to_back():
    """The kernel five times on one list spanning many partitions (equal
    results each time), then two different lists back to back on one
    stream, so the second sort's scratch is the first's (the caching
    allocator hands the same block back, look-back flags and all): each
    bit for bit with the plain version and the stable torch.sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the radix sort is a CUDA kernel with no CPU mode")
    rk.check_kernel_config()
    rng = np.random.default_rng(15)
    e = 200 * T + 11
    first = _elements(_list(rng, TILES_1080P, e, e - 5000), e - 5000, device="cuda")
    second = _elements(_list(rng, TILES_1080P, e, 150 * T + 3), 150 * T + 3, device="cuda")
    for el in (first, second):
        want, want_perm = _torch_sort(el, TILES_1080P)
        plain, plain_perm = tsort.sort_elements_radix_plain(el, TILES_1080P, with_perm=True)
        assert all(torch.equal(a, b) for a, b in zip(plain[:3], want))
        assert torch.equal(plain_perm, want_perm)
    want = _torch_sort(first, TILES_1080P)[0]
    runs = [rk.radix_sort(*first[:3], first.count, TILES_1080P) for _ in range(5)]
    torch.cuda.synchronize()
    for k, got in enumerate(runs):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"run {k}"
    for with_perm in (False, True):
        a = rk.radix_sort(*first[:3], first.count, TILES_1080P, with_perm=with_perm)
        b = rk.radix_sort(*second[:3], second.count, TILES_1080P, with_perm=with_perm)
        torch.cuda.synchronize()
        for el, got in ((first, a), (second, b)):
            ref, ref_perm = _torch_sort(el, TILES_1080P)
            assert all(torch.equal(x, y) for x, y in zip(got[:3], ref)), with_perm
            if with_perm:
                assert torch.equal(got[3], ref_perm)
